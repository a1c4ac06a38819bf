"""Timeseries sampler of `hyperspace_tpu_torch` (`telemetry/
timeseries.py`) against the JAX package: `quantile_from_buckets` and
`delta_buckets` give EQUAL results on seeded buckets, and the same
scripted ticks over the same series give equal samples, rates and window
quantiles in both packages. Also the ring, the `since` cursor and the
window gauges. Every sampler here is ticked by hand (`tick(t=...)`);
none runs its thread.

Process state: each test starts and ends with no port alert manager,
history writer or process sampler installed (`alerts.reset_manager`,
`history.reset_history`, `timeseries.reset_sampler`), so a tick's hooks
reach nothing but the sampler under test.
"""

import math

import numpy as np
import pytest
from torch_suites import jax_counters_guard  # noqa: E402,F401

from hyperspace_tpu import telemetry as jtelemetry
from hyperspace_tpu.telemetry import timeseries as jts
from hyperspace_tpu_torch import telemetry
from hyperspace_tpu_torch.telemetry import alerts, history, timeseries
from hyperspace_tpu_torch.telemetry.timeseries import (TimeSeriesSampler,
                                                       delta_buckets,
                                                       quantile_from_buckets)


@pytest.fixture(autouse=True)
def no_hooks():
    alerts.reset_manager()
    history.reset_history()
    timeseries.reset_sampler()
    yield
    alerts.reset_manager()
    history.reset_history()
    timeseries.reset_sampler()


def _buckets(rng, n_buckets):
    exps = rng.choice(np.arange(-30, 30), size=n_buckets, replace=False)
    out = {int(e): int(rng.integers(0, 50)) for e in exps}
    if rng.random() < 0.5:
        out[None] = int(rng.integers(0, 20))
    return out


def test_defaults_are_the_jax_packages():
    for name in ("DEFAULT_HISTOGRAMS", "DEFAULT_HISTOGRAM_PREFIXES",
                 "DEFAULT_COUNTER_PREFIXES", "WINDOW_RATE_COUNTERS",
                 "DEFAULT_GAUGE_PREFIXES", "WINDOW_QUANTILES",
                 "DEFAULT_INTERVAL_S", "DEFAULT_CAPACITY",
                 "DEFAULT_WINDOW_S"):
        assert getattr(timeseries, name) == getattr(jts, name), name


@pytest.mark.parametrize("seed", range(10))
def test_quantile_from_buckets_equals_jax(seed):
    rng = np.random.default_rng(seed)
    buckets = _buckets(rng, int(rng.integers(1, 12)))
    for q in (0.0, 0.01, 0.25, 0.5, 0.9, 0.99, 1.0):
        assert quantile_from_buckets(buckets, q) == \
            jts.quantile_from_buckets(buckets, q)


@pytest.mark.parametrize("seed", range(10))
def test_delta_buckets_equals_jax(seed):
    rng = np.random.default_rng(100 + seed)
    old = {"count": 0, "sum": 0.0, "buckets": _buckets(rng, 8)}
    new = {"count": 0, "sum": 0.0,
           "buckets": {e: n + int(rng.integers(-5, 30))
                       for e, n in old["buckets"].items()}}
    new["buckets"].update(_buckets(rng, 3))
    assert delta_buckets(new, old) == jts.delta_buckets(new, old)
    assert delta_buckets(new, None) == jts.delta_buckets(new, None)


def test_quantile_brackets_the_oracle():
    rng = np.random.default_rng(11)
    values = list(rng.lognormal(-3.0, 2.0, size=500)) + [0.25, 1.0, 4.0]
    buckets = {}
    for v in values:
        exp = math.ceil(math.log2(v))
        buckets[exp] = buckets.get(exp, 0) + 1
    s = sorted(values)
    for q in (0.01, 0.5, 0.9, 0.99, 1.0):
        oracle = s[max(1, math.ceil(q * len(s))) - 1]
        assert oracle <= quantile_from_buckets(buckets, q) < 2 * oracle
    assert quantile_from_buckets({}, 0.5) is None
    assert quantile_from_buckets({None: 1, 0: 99}, 0.99) == 1.0


@pytest.mark.parametrize("seed", range(4))
def test_scripted_ticks_equal_jax(seed):
    """The same observations and increments, the same tick times: both
    packages' samplers hold equal samples and answer equal window
    rates, deltas and quantiles."""
    rng = np.random.default_rng(seed)
    name = f"testts.s{seed}"
    samplers, regs = [], []
    for pkg, ts in ((telemetry, timeseries), (jtelemetry, jts)):
        reg = pkg.get_registry()
        regs.append(reg)
        samplers.append(ts.TimeSeriesSampler(
            interval_s=1.0, capacity=16, window_s=5.0,
            histograms=(f"{name}.wall",), counter_prefixes=(name,),
            gauge_prefixes=(name,), histogram_prefixes=()))
    t0 = 5000.0 + seed
    for i in range(12):
        values = rng.lognormal(-3.0, 1.0, size=int(rng.integers(0, 20)))
        inc = int(rng.integers(0, 7))
        gauge = float(rng.integers(0, 100))
        for reg in regs:
            h = reg.histogram(f"{name}.wall")
            for v in values:
                h.observe(float(v))
            reg.counter(f"{name}.count").inc(inc)
            reg.gauge(f"{name}.depth").set(gauge)
        got = [s.tick(t=t0 + i) for s in samplers]
        assert got[0] == got[1]
    ours, theirs = samplers
    assert ours.samples() == theirs.samples()
    for window in (2.0, 5.0, 30.0):
        assert ours.window_rate(f"{name}.count", window_s=window) == \
            theirs.window_rate(f"{name}.count", window_s=window)
        assert ours.window_delta(f"{name}.count", window_s=window) == \
            theirs.window_delta(f"{name}.count", window_s=window)
        for q in (0.5, 0.99):
            assert ours.window_quantile(f"{name}.wall", q,
                                        window_s=window) == \
                theirs.window_quantile(f"{name}.wall", q, window_s=window)


def test_ring_bounds_and_the_since_cursor():
    s = TimeSeriesSampler(interval_s=1.0, capacity=8)
    for i in range(50):
        s.tick(t=1000.0 + i)
    assert len(s) == 8
    assert [x["t"] for x in s.samples()] == [1042.0 + i for i in range(8)]
    assert len(s.samples(since_t=1045.0)) == 4
    snap = s.snapshot(since_seq=48)
    assert snap["last_seq"] == 50
    assert [x["seq"] for x in snap["samples"]] == [49, 50]
    assert not snap["running"]


def test_window_gauges_are_published():
    reg = telemetry.get_registry()
    s = TimeSeriesSampler(interval_s=1.0, capacity=16, window_s=2.0)
    s.tick(t=2000.0)
    reg.counter("queries.total").inc(4)
    for v in (0.01, 0.02, 0.04):
        reg.histogram("query.wall_s").observe(v)
    s.tick(t=2002.0)
    gauges = reg.series_snapshot()["gauges"]
    assert gauges["window.queries.total.rate"] == pytest.approx(2.0)
    assert gauges["window.query.wall_s.count"] >= 3
    assert gauges["timeseries.samples"] == 2


def test_configure_starts_only_with_an_ops_port():
    from hyperspace_tpu_torch import HyperspaceConf

    assert timeseries.configure(HyperspaceConf()) is None
    conf = HyperspaceConf({
        "spark.hyperspace.telemetry.ops.port": "0",
        "spark.hyperspace.telemetry.timeseries.interval.seconds": "30",
        "spark.hyperspace.telemetry.timeseries.capacity": "5"})
    sampler = timeseries.configure(conf)
    try:
        assert sampler is timeseries.get_sampler() and sampler.running
        assert sampler.interval_s == 30.0 and sampler._ring.maxlen == 5
        assert sampler.window_s == 60.0  # serve.slo.window.seconds
    finally:
        sampler.drain()
    assert not sampler.running
