"""Run bounds of a sorted sequence — the wrapper of the CUDA kernel
`csrc/run_bounds.cu`, the counting join's run scan (`ops/join.py`).

The kernel replaces no Pallas kernel: it stands in for the JAX package's
`jax.lax.cummax`/`cummin` pair (`hyperspace_tpu/ops/join.py`), which
PyTorch's own `cummax`/`cummin` computed on one block of the card. It is
bounded by device-memory bytes: the flags read once, both int64 outputs
written once, 17 bytes an element.

`run_bounds_reference` is the plain torch version of the same function
(the `cummax`/`cummin` pair). The wrapper takes it only for a tensor on
the CPU; for a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from hyperspace_tpu_torch.exceptions import HyperspaceException
from hyperspace_tpu_torch.telemetry.compilation import instrumented_device

# Bytes of device memory per element: one flag read, two int64 written.
BYTES_PER_ELEMENT = 17


def _check(differs: torch.Tensor) -> None:
    if not isinstance(differs, torch.Tensor) or differs.dim() != 1:
        raise HyperspaceException(
            "run_bounds takes one 1-D bool tensor of adjacent differences.")
    if differs.dtype != torch.bool:
        raise HyperspaceException(
            f"run_bounds flags must be bool, got {differs.dtype}.")
    if not differs.is_contiguous():
        raise HyperspaceException("run_bounds flags must be contiguous.")


def run_bounds_reference(differs: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version: a running max of run-start positions and a
    reversed running min of them."""
    _check(differs)
    T = differs.shape[0] + 1
    device = differs.device
    pos = torch.arange(T, dtype=torch.int64, device=device)
    run_start = torch.cat([torch.ones(1, dtype=torch.bool, device=device),
                           differs])
    run_first = torch.cummax(torch.where(run_start, pos, 0), 0).values
    nxt = torch.flip(torch.cummin(torch.flip(
        torch.where(run_start, pos, T), [0]), 0).values, [0])
    run_last = torch.cat([nxt[1:], torch.full((1,), T, dtype=torch.int64,
                                              device=device)]) - 1
    return run_first, run_last


_fns = None


def _kernel_fns():
    global _fns
    if _fns is None:
        from hyperspace_tpu_torch.ops.cuda import build

        lib = build.load("run_bounds")
        tiles = lib.hs_run_bounds_tiles
        tiles.argtypes = [ctypes.c_longlong]
        tiles.restype = ctypes.c_longlong
        fn = lib.hs_run_bounds
        fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns = (tiles, fn)
    return _fns


def run_bounds_cost(differs: torch.Tensor):
    """Modeled (operations, bytes accessed) of one call, for the device
    seam (`telemetry/compilation.py`): no arithmetic to speak of, and
    17 bytes for each of the T elements."""
    return 0, BYTES_PER_ELEMENT * (int(differs.shape[0]) + 1)


def _run_bounds(differs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(run_first, run_last): each sorted element's run's first and last
    position, from the (T-1) adjacent-key-difference flags. int64 [T]
    each, on the flags' device. A CUDA tensor launches the kernel (and
    counts one launch, for its two kernels); a CPU tensor runs the plain
    version."""
    _check(differs)
    if differs.device.type == "cpu":
        return run_bounds_reference(differs)
    if differs.device.type != "cuda":
        raise HyperspaceException(
            f"run_bounds: unsupported device {differs.device}")
    T = differs.shape[0] + 1
    if T == 1:
        zero = torch.zeros(1, dtype=torch.int64, device=differs.device)
        return zero, zero.clone()
    tiles, fn = _kernel_fns()
    # One buffer: run_first, run_last, then the kernel's per-tile scratch
    # (each tile's last start and first flag).
    n_scratch = 2 * tiles(T)
    buf = torch.empty(2 * T + n_scratch, dtype=torch.int64,
                      device=differs.device)
    run_first, run_last, _ = buf.split((T, T, n_scratch))
    stream = torch.cuda.current_stream(differs.device).cuda_stream
    with torch.cuda.device(differs.device):
        status = fn(differs.data_ptr(), T, buf.data_ptr(), stream)
    from hyperspace_tpu_torch.ops.cuda.build import check
    check(status, "run_bounds")
    run_bounds.launches += 1
    return run_first, run_last


# The entry point, through the device seam: device seconds and modeled
# bytes per call. `.launches` counts calls that launched the kernel (CUDA
# tensors only).
run_bounds = instrumented_device("cuda.run_bounds", _run_bounds,
                                 cost=run_bounds_cost)
run_bounds.launches = 0
