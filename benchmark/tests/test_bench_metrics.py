"""The arithmetic of every metric: the rate over the whole window, the
p95 over every request, the device's busy and idle time, and each
per-layer reader."""

import threading
import time

import numpy as np
import pytest

from benchmark import harness, spec, stats, streams
from benchmark.devtrace import Trace, merge
from benchmark.tests.cells import ROOT


def test_percentile_is_numpys_linear_percentile():
    rng = np.random.default_rng(3)
    for n in (1, 2, 7, 100, 1001):
        xs = list(rng.exponential(size=n))
        for q in (0, 50, 95, 100):
            assert stats.percentile(xs, q) == pytest.approx(np.percentile(xs, q))


class _Frame:
    def __init__(self, seconds):
        self.seconds = seconds

    def collect(self):
        time.sleep(self.seconds)
        return "table"


def test_window_rate_and_p95_count_every_request_and_a_stall():
    """One request stalls past the deadline: the window waits for it, the
    rate is over the whole window, and the p95 is over every request."""
    stalled = threading.Event()

    def slow(_dfs):
        if not stalled.is_set():
            stalled.set()
            return _Frame(0.6)
        return _Frame(0.01)

    builders = {"fast": lambda _dfs: _Frame(0.01), "slow": slow}
    orders = [["fast"], ["slow"]]
    records, begin, end = harness.drive(builders, None, orders, 0.3,
                                        harness.Spans(), None)
    assert all(r.error is None for r in records)
    stall = max(records, key=lambda r: r.end - r.start)
    assert stall.end - stall.start >= 0.6
    assert end == pytest.approx(stall.end) and end - begin >= 0.6
    lat = [(r.end - r.start) * 1e3 for r in records]
    assert stats.rate(len(records), end - begin) == len(records) / (end - begin)
    assert stats.percentile(lat, 95) == pytest.approx(np.percentile(lat, 95))
    assert stats.percentile(lat, 100) >= 600


def test_a_failed_query_is_recorded_and_the_stream_goes_on():
    def bad(_dfs):
        raise RuntimeError("boom")

    records, _, _ = harness.drive({"bad": bad, "ok": lambda _d: _Frame(0.01)},
                                  None, [["bad", "ok"]], 0.1,
                                  harness.Spans(), None)
    assert any(r.error and "boom" in r.error for r in records)
    assert any(r.error is None for r in records)


def _trace():
    # stretch 0..100 us; kernels 10-30 and 20-40 overlap; scan 60-70
    return Trace(t0_us=0.0, t1_us=100.0,
                 device=[("k1", 10.0, 30.0), ("k2", 20.0, 40.0),
                         ("tensor_kernel_scan_innermost_dim_with_indices", 60.0, 70.0),
                         ("late", 95.0, 130.0)],
                 spans=[("collect:q1", 0.0, 55.0), ("collect:q2", 45.0, 100.0)])


def test_trace_busy_idle_and_gaps():
    t = _trace()
    assert merge([(3, 5), (1, 2), (4, 8)]) == [(1, 2), (3, 8)]
    assert t.busy() == [(10.0, 40.0), (60.0, 70.0), (95.0, 100.0)]
    assert t.busy_s == pytest.approx(45e-6)
    gaps = t.idle_gaps(10)
    assert [g[1] for g in gaps] == pytest.approx([25e-6, 20e-6, 10e-6])
    assert gaps[0][0] == "collect:q2 @0.000s"
    assert gaps[1][0] == "collect:q1+collect:q2 @0.000s"
    assert gaps[2][0] == "collect:q1 @0.000s"
    assert t.top_ops(2)[0] == ["k1", pytest.approx(20e-6)]


def _readings(**kw):
    base = dict(completed=10, window_s=5.0, counters={}, histograms={},
                window_trace=_trace(), build_trace=None, build_s=12.5,
                index_keys={}, device_kind="NVIDIA H100 80GB HBM3")
    base.update(kw)
    return harness.Readings(**base)


def read(name, r):
    return spec.metric_reader(ROOT, name)(r)


def test_each_per_layer_reader():
    r = _readings(counters={"cache.segments.hits": 30.0,
                            "cache.segments.misses": 10.0,
                            "link.h2d.bytes": 5e6})
    assert read("device.idle_share", r) == pytest.approx(55.0)
    assert read("join.scan_share", r) == pytest.approx(100 * 10 / 45)
    assert read("segcache.hit_rate", r) == pytest.approx(75.0)
    assert read("link.h2d_mb_per_query", r) == pytest.approx(0.5)
    assert read("build.index_s", r) == 12.5


def test_readers_that_find_nothing_return_nothing():
    r = _readings(window_trace=None, build_s=0.0)
    for name in ("device.idle_share", "join.scan_share", "segcache.hit_rate",
                 "build.index_s",
                 "kernel.hash_roofline"):
        assert read(name, r) is None, name


def test_hash_roofline_counts_each_build_once():
    """Least time is rows x (4 x lanes + 4) bytes at 3.35 TB/s, per index
    build, over the device time of its launches."""
    rows, lanes = 1_000_000, 2
    least_us = rows * 12 / 3.35e12 * 1e6
    build = Trace(t0_us=0.0, t1_us=1e6,
                  device=[("hash_lanes_to_buckets_kernel", 100.0, 100.0 + 2 * least_us),
                          ("other", 200.0, 300.0),
                          ("hash_lanes_to_buckets_kernel", 5e5, 5e5 + 1.0)],
                  spans=[("create_index:a", 0.0, 4e5),
                         ("create_index:b", 4e5, 4.5e5)])
    r = _readings(build_trace=build, index_keys={"a": (rows, lanes),
                                                 "b": (5, 1)})
    assert read("kernel.hash_roofline", r) == pytest.approx(50.0)
    r = _readings(build_trace=build, device_kind="cpu")
    assert read("kernel.hash_roofline", r) is None


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 11, 2 ** 40 + 3, -5])
def test_streams_rotate_one_permutation_drawn_from_the_seed(seed):
    traffic = {"loop": "closed-rotation", "streams": 4,
               "queries": [f"q{i}" for i in range(57)]}
    orders = streams.stream_orders(traffic, seed)
    assert orders == streams.stream_orders(traffic, seed)
    assert len(orders) == 4 and len({tuple(o) for o in orders}) == 4
    for i, o in enumerate(orders):
        assert sorted(o) == sorted(traffic["queries"])
        assert o == orders[0][i * 57 // 4:] + orders[0][:i * 57 // 4]
    assert orders != streams.stream_orders(traffic, seed + 1)
