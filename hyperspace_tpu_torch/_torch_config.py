"""The port's device choice — the counterpart of the JAX package's
`_jax_config.py`.

Every entry point that places data (`HyperspaceSession`, the build, the
device lane of a scan) resolves its device here. The default is the CUDA
card; the CPU is used only when the caller names it (`device="cpu"`, as
the CPU tests do). Where CUDA is absent and the caller did not ask for the
CPU, resolution raises: the port never carries on quietly on the CPU.

x64 needs no switch in torch: int64 and float64 are native dtypes.
"""

from __future__ import annotations

from typing import Union

import torch

from hyperspace_tpu_torch.exceptions import HyperspaceException

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """`device` as a `torch.device`: None means the CUDA card. A CUDA
    device on a machine without one raises `HyperspaceException`."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise HyperspaceException(
            "hyperspace_tpu_torch runs on a CUDA device by default and none "
            "is available; pass device='cpu' to run on the CPU.")
    if dev.type not in ("cuda", "cpu"):
        raise HyperspaceException(f"Unsupported device: {dev}")
    return dev


def device_of(conf) -> torch.device:
    """The device a session's conf names (`spark.hyperspace.device`;
    unset or no conf means the CUDA card)."""
    from hyperspace_tpu_torch.constants import DEVICE

    return resolve_device(conf.get(DEVICE) if conf is not None else None)

