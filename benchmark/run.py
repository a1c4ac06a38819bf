"""The benchmark of `hyperspace_tpu_torch`, one run of one cell.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. Everything the run needs is found by the
cell's name in `BENCHMARK.json` (see `benchmark/README.md`); the last line
of standard output is the run's result as one JSON object.
"""

import time

PROCESS_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fixed_caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout,
    so that only a cell's first run in a checkout compiles anything."""
    cache = os.path.join(ROOT, "benchmark", "_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(cache, "cuda")
    # No library the port uses may load JAX behind its back.
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def main() -> int:
    _fixed_caches()
    sys.path.insert(0, ROOT)
    from benchmark import harness
    return harness.main(sys.argv[1:], ROOT, PROCESS_START)


if __name__ == "__main__":
    sys.exit(main())
