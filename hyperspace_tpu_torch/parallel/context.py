"""Distribution context: decides whether the data plane runs on a mesh.

The JAX package's "cluster" is the set of visible jax devices; the
port's is `parallel/virtual.devices()` when a virtual list is set, else
the CUDA cards when the session runs on one. The policy is the JAX
package's. `spark.hyperspace.distribution.enabled`:

- "auto" (default): distribute when more than one device is visible,
  the batch is device-resident and holds at least
  `distribution.min.rows` rows;
- "true": distribute regardless (a no-op on a single device — there is
  no mesh to use);
- "false": always single-device.
"""

from __future__ import annotations

import contextlib
import contextvars
import logging
from typing import Optional, Tuple

from hyperspace_tpu_torch import constants

# Replica scope (the JAX package's `parallel/replica.py` routes a query to
# one slice of a multi-slice mesh): under a scope every distribution
# decision sees THAT slice's flat submesh. A contextvar, so the scope
# follows the query across `telemetry.propagating` pool threads.
_replica_slice: contextvars.ContextVar = contextvars.ContextVar(
    "hs_replica_slice", default=None)


def active_replica() -> Optional[int]:
    """The replica slice the current context is pinned to, or None."""
    return _replica_slice.get()


@contextlib.contextmanager
def replica_scope(slice_idx: Optional[int]):
    """Pin distribution decisions in this context to replica
    `slice_idx` (None = no pin; the scope is then a no-op)."""
    if slice_idx is None:
        yield
        return
    token = _replica_slice.set(int(slice_idx))
    try:
        yield
    finally:
        _replica_slice.reset(token)


def _visible_count(conf) -> int:
    """Devices the conf's session can distribute over: the virtual list
    first, else the CUDA device count when the session runs on a card,
    else 1 (the CPU)."""
    from hyperspace_tpu_torch.parallel import virtual

    if virtual.is_virtual():
        return len(virtual.devices())
    import torch

    from hyperspace_tpu_torch.constants import DEVICE

    name = conf.get(DEVICE) if conf is not None else None
    if torch.device(name or "cuda").type != "cuda":
        return 1
    if not torch.cuda.is_available():
        return 0
    return torch.cuda.device_count()


def topology(conf=None) -> Optional[Tuple[int, int]]:
    """(n_slices, n_ici) of the configured topology, or None when fewer
    than two devices are visible or distribution is off. n_slices folds
    back to 1 when the knob does not divide the device count."""
    mode = conf.distribution if conf is not None else "auto"
    if mode == "false":
        return None
    n = _visible_count(conf)
    if n < 2:
        return None
    slices = (conf.distribution_slices if conf is not None
              else constants.DISTRIBUTION_DCN_SIZE_DEFAULT)
    if slices > 1 and n % slices != 0:
        logging.getLogger(__name__).warning(
            "distribution.slices=%d does not divide the %d visible "
            "devices; falling back to a FLAT mesh.", slices, n)
        slices = 1
    slices = max(1, slices)
    return slices, n // slices


def distribution_mesh(conf=None):
    """The mesh to distribute over, or None for single-device execution.
    Under an active replica scope on a multi-slice topology, the pinned
    slice's flat submesh."""
    topo = topology(conf)
    if topo is None:
        return None
    slices, ici = topo
    from hyperspace_tpu_torch.parallel.mesh import make_mesh, slice_submesh

    mesh = make_mesh(slices * ici, dcn_size=slices if slices > 1 else None)
    replica = active_replica()
    if replica is not None and slices > 1:
        return slice_submesh(mesh, replica % slices)
    return mesh


def mesh_size(mesh) -> int:
    """TOTAL shard count of the mesh (both axes of a (dcn, shard) mesh)."""
    from hyperspace_tpu_torch.parallel.mesh import total_shards

    return total_shards(mesh)


def should_distribute(conf, num_rows: Optional[int] = None,
                      host_batch: bool = False):
    """Mesh to use for this operation, or None. In "auto" mode small
    batches stay single-device and HOST-lane batches stay on the host
    (they avoided the device on purpose); "true" distributes regardless.
    THE policy seam: every operator with a mesh path asks here."""
    mesh = distribution_mesh(conf)
    if mesh is None:
        return None
    mode = conf.distribution if conf is not None else "auto"
    if mode == "auto" and host_batch:
        return None
    min_rows = (conf.distribution_min_rows if conf is not None
                else constants.DISTRIBUTION_MIN_ROWS_DEFAULT)
    if mode == "auto" and num_rows is not None and num_rows < min_rows:
        return None
    return mesh
