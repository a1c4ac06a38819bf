"""join.scan_share (%): the share of the card's busy time in the traced
stretch spent in torch's scan kernels, the `cummax`/`cummin` that the
counting join (`ops/join.py` `_run_bounds`) runs."""

from benchmark.devtrace import length


def is_scan(name: str) -> bool:
    return "scan_innermost_dim_with_indices" in name or \
        "scan_outer_dim_with_indices" in name


def read(r):
    t = r.window_trace
    if t is None:
        return None
    busy = length(t.busy())
    if busy <= 0:
        return None
    return 100.0 * length(t.busy(is_scan)) / busy
