"""String builder honoring the display mode.

Parity: reference `index/plananalysis/BufferStream.scala:23-83`
(`writeLine`/`write`/`highlight`/`withTag`).
"""

from __future__ import annotations

from hyperspace_tpu_torch.plananalysis.display_mode import DisplayMode


class BufferStream:
    def __init__(self, mode: DisplayMode):
        self.mode = mode
        self._parts: list[str] = []

    def write(self, text: str = "") -> "BufferStream":
        self._parts.append(text)
        return self

    def write_line(self, text: str = "") -> "BufferStream":
        self._parts.append(text + self.mode.newline)
        return self

    def highlight(self, text: str) -> "BufferStream":
        self._parts.append(self.mode.highlight(text))
        return self

    def highlight_line(self, text: str) -> "BufferStream":
        self._parts.append(self.mode.highlight(text) + self.mode.newline)
        return self

    def to_string(self) -> str:
        return "".join(self._parts)
