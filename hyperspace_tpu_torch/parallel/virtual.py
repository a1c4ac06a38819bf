"""The port's visible device list, and the virtual mesh for tests and
for a host with one card.

The JAX package validates distribution on an n-device virtual CPU mesh
(`jax_num_cpu_devices`, set once per process). The port's counterpart is
a list of n LOGICAL shards: `ensure_devices(n)` makes `devices()` report
n devices — the real CUDA devices when at least n are visible, otherwise
n shards on one device (`device`, or the first card, or the CPU when no
card is present). Every shard of a virtual mesh is a separate tensor, so
the exchange, the per-shard kernels and the combine run exactly as on n
cards; only the slab moves are free.

Unlike the JAX bootstrap the list is undone by `reset()` (or the
`virtual_devices` context manager), so a test or a smoke-run phase
leaves no mesh behind for the next.
"""

from __future__ import annotations

import contextlib
import threading
from typing import List, Optional

import torch

_lock = threading.Lock()
_virtual: Optional[List[torch.device]] = None


def _canonical(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def devices() -> List[torch.device]:
    """The visible device list: the virtual list when one is set, else
    every CUDA device, else the CPU."""
    with _lock:
        if _virtual is not None:
            return list(_virtual)
    if torch.cuda.is_available():
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def is_virtual() -> bool:
    """True while a virtual shard list is set."""
    with _lock:
        return _virtual is not None


def ensure_devices(n_devices: int, device=None) -> List[torch.device]:
    """Make `devices()` report ``n_devices`` devices. With at least that
    many CUDA devices visible (and no CPU `device` named) the real cards
    are used and nothing is set; otherwise the list becomes
    ``n_devices`` shards on `device` (default: the first card, or the CPU
    without one). Returns the list."""
    global _virtual
    if n_devices < 1:
        raise ValueError(f"need at least one device, asked {n_devices}")
    wants_card = device is None or torch.device(device).type == "cuda"
    if (wants_card and torch.cuda.is_available()
            and torch.cuda.device_count() >= n_devices):
        reset()
        return devices()
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = _canonical(device)
    with _lock:
        _virtual = [dev] * n_devices
        return list(_virtual)


def reset() -> None:
    """Drop the virtual list: `devices()` reports the real devices."""
    global _virtual
    with _lock:
        _virtual = None


@contextlib.contextmanager
def virtual_devices(n_devices: int, device=None):
    """`ensure_devices` for the body of a `with`, restoring the list that
    was set before (None included) on the way out."""
    global _virtual
    with _lock:
        saved = None if _virtual is None else list(_virtual)
    try:
        yield ensure_devices(n_devices, device)
    finally:
        with _lock:
            _virtual = saved
