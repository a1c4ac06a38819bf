"""hyperspace_tpu_torch — the covering-index subsystem on PyTorch and CUDA.

The PyTorch counterpart of `hyperspace_tpu`: users create covering indexes
— bucketed, sorted, columnar copies of selected columns — over Parquet
files, with all index data and metadata stored on the lake behind an
optimistic-concurrency operation log (the same on-lake format as
`hyperspace_tpu`, so each package serves the other's indexes), and a
rewrite layer that redirects filter and equi-join queries to the indexes.
Data-skipping indexes — per-file zone maps and bloom filters, optionally
over a Z-order clustered copy — prune the files a filter reads. The
control plane is Python; the data plane is torch tensors on a CUDA
card, with the build's bucket hash and the Exchange's partition step as
hand-written CUDA kernels (`csrc/`). Nothing here imports JAX or
`hyperspace_tpu`.
"""

__version__ = "0.1.0"

from hyperspace_tpu_torch.exceptions import (HyperspaceException,
                                       IndexDataUnavailableError)
from hyperspace_tpu_torch.config import HyperspaceConf
from hyperspace_tpu_torch.index.index_config import (DataSkippingIndexConfig,
                                                     IndexConfig)

_LAZY = {
    "Hyperspace": ("hyperspace_tpu_torch.facade", "Hyperspace"),
    "HyperspaceSession": ("hyperspace_tpu_torch.engine.session", "HyperspaceSession"),
    "DataFrame": ("hyperspace_tpu_torch.engine.dataframe", "DataFrame"),
    "col": ("hyperspace_tpu_torch.plan.expr", "col"),
    "lit": ("hyperspace_tpu_torch.plan.expr", "lit"),
    # the observability surface: `hs.telemetry.enable_tracing()`,
    # `hs.telemetry.export_trace(path)`, `hs.telemetry.get_registry()`
    "telemetry": ("hyperspace_tpu_torch.telemetry", None),
}


def __getattr__(name):
    target = _LAZY.get(name)
    if target is None:
        raise AttributeError(f"module 'hyperspace_tpu_torch' has no attribute {name!r}")
    import importlib
    module = importlib.import_module(target[0])
    value = getattr(module, target[1]) if target[1] is not None else module
    globals()[name] = value
    return value


__all__ = ["HyperspaceException", "IndexDataUnavailableError",
           "HyperspaceConf", "IndexConfig", "DataSkippingIndexConfig",
           "Hyperspace", "HyperspaceSession", "DataFrame", "col", "lit",
           "telemetry", "__version__"]
