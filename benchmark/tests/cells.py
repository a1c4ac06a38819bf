"""Runs of the benchmark's cells on the CPU at a tiny size, for the tests.

The harness's look for a card is skipped; everything else of a run is
driven as on the card: the lake from the seed, the indexes, the warm-up,
the window of streams and the comparison with the reference.
"""

from __future__ import annotations

import os
import time

from benchmark import harness, spec

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# Generator scales a test run can hold (the cell runs 100).
TINY = {"tpch-sf1": 0.3}
SEED = 2 ** 31 + 99


def tiny_cell(name: str) -> spec.Cell:
    cell = spec.find_cell(ROOT, name)
    cell.config["generator_scale"] = TINY[cell.config["name"]]
    return cell


def run_tiny(name: str, seconds: float = 1.0, trace: bool = False,
             seed: int = SEED) -> dict:
    return harness.run_cell(ROOT, tiny_cell(name), seed, seconds, trace,
                            time.perf_counter(), device="cpu")
