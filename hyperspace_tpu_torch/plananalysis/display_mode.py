"""Explain output display modes.

Parity: reference `index/plananalysis/DisplayMode.scala:24-89` —
PlainTextMode (`<----`/`---->`), HTMLMode (`<b style=...>`), ConsoleMode
(ANSI green), with tags configurable via
`spark.hyperspace.explain.displayMode.highlight.{begin,end}Tag`.
"""

from __future__ import annotations

from hyperspace_tpu_torch import constants
from hyperspace_tpu_torch.config import HyperspaceConf


class DisplayMode:
    begin_tag: str = ""
    end_tag: str = ""
    newline: str = "\n"

    def highlight(self, text: str) -> str:
        return f"{self.begin_tag}{text}{self.end_tag}"


class PlainTextMode(DisplayMode):
    def __init__(self, conf: HyperspaceConf | None = None):
        conf = conf or HyperspaceConf()
        self.begin_tag = conf.get(constants.HIGHLIGHT_BEGIN_TAG, "<----")
        self.end_tag = conf.get(constants.HIGHLIGHT_END_TAG, "---->")


class ConsoleMode(DisplayMode):
    def __init__(self, conf: HyperspaceConf | None = None):
        conf = conf or HyperspaceConf()
        self.begin_tag = conf.get(constants.HIGHLIGHT_BEGIN_TAG, "[32m")
        self.end_tag = conf.get(constants.HIGHLIGHT_END_TAG, "[0m")


class HTMLMode(DisplayMode):
    newline = "<br>"

    def __init__(self, conf: HyperspaceConf | None = None):
        conf = conf or HyperspaceConf()
        self.begin_tag = conf.get(constants.HIGHLIGHT_BEGIN_TAG,
                                  '<b style="background:LightGreen">')
        self.end_tag = conf.get(constants.HIGHLIGHT_END_TAG, "</b>")


def get_display_mode(conf: HyperspaceConf) -> DisplayMode:
    name = conf.get(constants.DISPLAY_MODE, constants.DisplayModeNames.PLAIN_TEXT)
    if name == constants.DisplayModeNames.HTML:
        return HTMLMode(conf)
    if name == constants.DisplayModeNames.CONSOLE:
        return ConsoleMode(conf)
    return PlainTextMode(conf)
