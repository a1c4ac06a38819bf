"""The device mesh — THE layout-spec seam of the port's distribution.

The JAX package's cluster is a `jax.sharding.Mesh` over TPU chips and
its data movement is XLA collectives inside `shard_map`. The port is a
SINGLE CONTROLLER: one process holds every shard. A `Mesh` is the
ordered tuple of `torch.device`s in flat shard order, with its axis
names and grid shape; a sharded array is a Python list of per-shard
tensors, shard `s` on `mesh.devices[s]`; an exchange moves per-peer
slabs with `.to(peer)` (`parallel/build._route_stage`). There is no
`torch.distributed`, no process group and no socket. On a host with
several GPUs a slab move is a peer copy; on one card (a virtual mesh,
`parallel/virtual.py`) or on the CPU every shard sits on one device and
the moves cost nothing.

Mesh shapes: a flat `(shard,)` mesh, or with `dcn_size` > 1 a 2-axis
`(dcn, shard)` mesh whose flat order is row-major, `s = d * n_ici + i`.

Bucket <-> shard ownership: flat shard `s` of an `n`-shard mesh owns the
CONTIGUOUS bucket range `[ceil(s*B/n), ceil((s+1)*B/n))`, i.e.
`bucket_owner(b) = b*n // B`. The build's routing, the born-sharded
parquet layout and the layout record all derive from `bucket_ranges` /
`bucket_owner` below, which are pure arithmetic equal to the JAX
package's functions.

The JAX module's `compat_shard_map`, `shard_rows`, `replicated` and
`row_spec` build `shard_map` bodies, `NamedSharding`s and
`PartitionSpec`s. Torch has no counterpart of any of them: placement is
the list itself (`io/transfer.TransferEngine.put` with a mesh places
shard `s`'s rows on `mesh.devices[s]`), and a replicated value is one
copy per device, made where it is needed.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

SHARD_AXIS = "shard"
DCN_AXIS = "dcn"


@dataclass(frozen=True)
class Mesh:
    """`devices`: flat shard order (row-major over `axis_names`);
    `grid`: the size of each axis; `virtual`: the shards are logical
    shards of fewer physical devices (`parallel/virtual.py`);
    `ordinals`: each shard's flat position in the topology the mesh was
    cut from (`make_mesh` numbers them 0..n-1, `slice_submesh` keeps
    the slice's share), so two slices of one virtual mesh stay apart."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...]
    grid: Tuple[int, ...]
    virtual: bool = False
    ordinals: Tuple[int, ...] = ()

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, outer axis first (the JAX `Mesh.shape`)."""
        return dict(zip(self.axis_names, self.grid))


def make_mesh(num_devices: Optional[int] = None,
              dcn_size: Optional[int] = None) -> Mesh:
    """1-axis `(shard,)` mesh over the first `num_devices` visible
    devices (`parallel/virtual.devices`), or — with `dcn_size` > 1 — a
    2-axis `(dcn, shard)` mesh of `dcn_size` slices."""
    from hyperspace_tpu_torch import telemetry
    from hyperspace_tpu_torch.parallel import virtual

    devices = virtual.devices()
    if num_devices is not None:
        if len(devices) < num_devices:
            raise ValueError(
                f"Requested {num_devices} devices, have {len(devices)}.")
        devices = devices[:num_devices]
    telemetry.get_registry().gauge("mesh.devices").set(len(devices))
    is_virtual = virtual.is_virtual()
    ordinals = tuple(range(len(devices)))
    if dcn_size is not None and dcn_size > 1:
        if len(devices) % dcn_size != 0:
            raise ValueError(
                f"dcn size {dcn_size} must divide device count "
                f"{len(devices)}.")
        return Mesh(tuple(devices), (DCN_AXIS, SHARD_AXIS),
                    (dcn_size, len(devices) // dcn_size), is_virtual,
                    ordinals)
    return Mesh(tuple(devices), (SHARD_AXIS,), (len(devices),), is_virtual,
                ordinals)


def row_axes(mesh: Mesh) -> Tuple[str, ...]:
    """The axis names the ROW dimension shards over — every axis, outer
    (dcn) first, so flat shard order is row-major (dcn, shard)."""
    return tuple(mesh.axis_names)


def total_shards(mesh: Mesh) -> int:
    return math.prod(mesh.grid)


def dcn_size(mesh: Mesh) -> int:
    """Number of slices (1 on a flat single-axis mesh)."""
    return mesh.shape.get(DCN_AXIS, 1)


def ici_size(mesh: Mesh) -> int:
    """Devices per slice (the inner axis; the whole mesh when flat)."""
    return mesh.shape.get(SHARD_AXIS, total_shards(mesh))


def slice_of_shard(shard: int, n_ici: int) -> int:
    """Owning slice of flat shard `shard` under row-major (dcn, shard)
    flat order."""
    return shard // n_ici


def slice_submesh(mesh: Mesh, idx: int) -> Mesh:
    """Flat 1-axis submesh over slice `idx`'s devices (the JAX package's
    replica execution mesh). On a flat mesh only slice 0 exists and the
    mesh is returned as is."""
    if len(mesh.grid) == 1:
        if idx != 0:
            raise ValueError(f"flat mesh has one slice; asked for {idx}")
        return mesh
    n_dcn, n_ici = mesh.grid
    if not 0 <= idx < n_dcn:
        raise ValueError(
            f"slice {idx} out of range for a {n_dcn}-slice mesh")
    cut = slice(idx * n_ici, (idx + 1) * n_ici)
    return Mesh(mesh.devices[cut], (SHARD_AXIS,), (n_ici,), mesh.virtual,
                mesh.ordinals[cut])


def mesh_device_tag(mesh: Mesh) -> tuple:
    """Stable identity of the mesh's device set in flat shard order —
    the replica discriminator in the segment cache's born-sharded keys
    and `parallel/spmd.dispatch_guard`'s lock set: the CUDA ordinal of
    each shard's device. Virtual shards share a device, so their tag is
    each shard's ordinal in the topology it was cut from (the JAX
    package's virtual CPU device ids): slice 1 of a 2 x 2 mesh tags
    (2, 3)."""
    if mesh.virtual:
        return mesh.ordinals or tuple(range(len(mesh.devices)))
    return tuple(d.index if d.index is not None else i
                 for i, d in enumerate(mesh.devices))


# -- contiguous bucket-range ownership --------------------------------------
#
# THE bucket <-> shard map (module docstring); equal to the JAX package's
# functions of the same names.


def bucket_ranges(num_buckets: int, n_shards: int) -> List[Tuple[int, int]]:
    """[(lo, hi)) bucket range per flat shard: shard s owns
    `[ceil(s*B/n), ceil((s+1)*B/n))` — contiguous, balanced to within one
    bucket."""
    return [((s * num_buckets + n_shards - 1) // n_shards,
             ((s + 1) * num_buckets + n_shards - 1) // n_shards)
            for s in range(n_shards)]


def bucket_owner(bucket, num_buckets: int, n_shards: int):
    """Owning flat shard of `bucket` (scalar, numpy array or int64
    tensor) — the exact inverse of `bucket_ranges`."""
    return bucket * n_shards // num_buckets


def slice_bucket_ranges(num_buckets: int, n_slices: int,
                        n_ici: int) -> List[Tuple[int, int]]:
    """[(lo, hi)) bucket range per SLICE of an (n_slices x n_ici)
    topology. Slice d's union of its shards' ranges is
    `bucket_ranges(B, n_slices)[d]`, so the inner size does not enter."""
    del n_ici
    return bucket_ranges(num_buckets, n_slices)


def shard_row_segments(lengths, n_shards: int) -> List[Tuple[int, int]]:
    """Per-shard (row_start, row_end) into a bucket-ordered row space:
    shard s's rows are exactly its bucket range's rows. `lengths` is the
    [num_buckets] per-bucket row-count vector."""
    lengths = np.asarray(lengths, dtype=np.int64)
    cum = np.concatenate([[0], np.cumsum(lengths)])
    return [(int(cum[lo]), int(cum[hi]))
            for lo, hi in bucket_ranges(len(lengths), n_shards)]


def mesh_device_list(mesh: Mesh) -> List[torch.device]:
    """The mesh's devices in FLAT shard order."""
    return list(mesh.devices)


def device_of_shard(mesh: Mesh, shard: int) -> torch.device:
    """The device holding flat shard `shard`."""
    return mesh.devices[shard]


def assemble_sharded_rows(mesh: Mesh,
                          per_device_arrays: Sequence[torch.Tensor]
                          ) -> List[torch.Tensor]:
    """The sharded form of per-shard arrays (array i on
    `mesh.devices[i]`): the list itself, with no data movement. The JAX
    package builds one global array here; a list of shards is the
    port's global array."""
    if len(per_device_arrays) != total_shards(mesh):
        raise ValueError(
            f"{len(per_device_arrays)} arrays for a "
            f"{total_shards(mesh)}-shard mesh")
    for s, arr in enumerate(per_device_arrays):
        if arr.device != mesh.devices[s]:
            raise ValueError(
                f"shard {s} lies on {arr.device}, not {mesh.devices[s]}")
    return list(per_device_arrays)
