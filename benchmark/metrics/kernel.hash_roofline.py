"""kernel.hash_roofline (%): the least time over the measured time of the
set-up builds' `hash_lanes_to_buckets` launches. The least time is the
bytes an index build's hash needs, rows x (4 x key lanes + 4), at the
card's published HBM bandwidth; the measured time is the launches'
device time in the profiler's trace of the builds."""

from benchmark import roofline


def read(r):
    t = r.build_trace
    peak = roofline.hbm_bytes_per_s(r.device_kind)
    if t is None or not peak:
        return None
    least = measured = 0.0
    for span in t.spans:
        name = span[0]
        if not name.startswith("create_index:"):
            continue
        launches = [k for k in t.within(span)
                    if "hash_lanes_to_buckets" in k[0]]
        if not launches:
            continue
        rows, lanes = r.index_keys[name.split(":", 1)[1]]
        least += roofline.hash_kernel_bytes(rows, lanes) / peak
        measured += sum(e - s for _, s, e in launches) / 1e6
    if measured <= 0:
        return None
    return 100.0 * least / measured
