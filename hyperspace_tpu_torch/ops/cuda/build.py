"""Build and load the port's hand-written CUDA kernels.

Each source under `hyperspace_tpu_torch/csrc/` is compiled by `nvcc` for
Hopper (`sm_90a`) into a shared library with a plain C interface and loaded
with `ctypes`. The build runs at first use, from the sources in the
checkout only, into `hyperspace_tpu_torch/_build/` (listed in
`.gitignore`); a library is named by its source's content hash, so an
edited source is rebuilt and an unchanged one is loaded as it is.
`build_all` starts one `nvcc` per source at once and waits for all of them.

Every build is counted by the compile seam (`telemetry/compilation.py`):
a build is a `compile.traces` (a `retrace` when an older build of the
library is there, i.e. its source changed), a load of a library that is
already built a `compile.cache_hits`. A failed build raises.

Nothing here runs at import time: the CPU tests import every module and
this machine may have no `nvcc`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Sequence

from hyperspace_tpu_torch.exceptions import HyperspaceException

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

# kernel library name -> source file under csrc/
SOURCES: Dict[str, str] = {
    "hash_buckets": "hash_buckets.cu",
    "partition_histogram": "partition_histogram.cu",
}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_loaded: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise HyperspaceException(
        "nvcc not found: the port's CUDA kernels build with the CUDA "
        "toolkit at first use on a machine with a card.")


def library_path(name: str) -> str:
    src = os.path.join(CSRC_DIR, SOURCES[name])
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()
                                ).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def _start(name: str):
    """Start `nvcc` for one library into a temporary path; None if the
    library is already built."""
    out = library_path(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(CSRC_DIR, SOURCES[name])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT)
    return proc, tmp, out


def _finish(name: str, started) -> None:
    proc, tmp, out = started
    output, _ = proc.communicate()
    if proc.returncode != 0:
        raise HyperspaceException(
            f"nvcc failed for {SOURCES[name]} (exit {proc.returncode}):\n"
            + output.decode(errors="replace"))
    os.replace(tmp, out)


def build_all(names: Sequence[str] = tuple(SOURCES)) -> Dict[str, float]:
    """Compile every named library not yet built, all `nvcc` processes at
    once. Returns {name: seconds from start until its build ended} (0.0
    for a library that was already built)."""
    from hyperspace_tpu_torch.telemetry import compilation

    t0 = time.perf_counter()
    with _lock:
        causes = {name: compilation.build_cause(
            BUILD_DIR, f"lib{name}-", f"csrc/{SOURCES[name]}")
            for name in names}
        started = {name: _start(name) for name in names}
        seconds: Dict[str, float] = {}
        try:
            for name, job in started.items():
                if job is not None:
                    _finish(name, job)
                    seconds[name] = time.perf_counter() - t0
                    compilation.record_build(name, seconds[name],
                                             causes[name])
                else:
                    seconds[name] = 0.0
                    compilation.record_cache_hit(name)
        finally:
            for job in started.values():
                if job is not None and job[0].poll() is None:
                    job[0].kill()
                    job[0].wait()
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library `name`, building it first if needed."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    build_all([name])
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(library_path(name))
            _loaded[name] = lib
    return lib


def check(status: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if status != 0:
        raise HyperspaceException(
            f"CUDA kernel {kernel} failed to launch: cudaError {status}")
