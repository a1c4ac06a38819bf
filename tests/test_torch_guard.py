"""The JAX registry guard that every port parity test file imports
(`tests/torch_suites.jax_counters_restored`): a block that runs JAX
scenarios leaves the JAX package's counters, gauges and histograms as it
found them.

The histogram case is the one behind `tests/test_advisor.py`'s two
contention cases failing in a shared worker: a served skipping query
observes `skipping.measured_prune_fraction`, and the JAX advisor then
scores skipping candidates with the measured mean instead of its conf
assumption, so a skipping candidate outranks the covering one.
"""

import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
from torch_suites import jax_counters_guard  # noqa: E402,F401
from torch_suites import jax_counters_restored

from hyperspace_tpu import telemetry
from hyperspace_tpu.advisor.whatif import measured_prune_fraction
from hyperspace_tpu.config import HyperspaceConf
from hyperspace_tpu.engine.session import HyperspaceSession
from hyperspace_tpu.facade import Hyperspace
from hyperspace_tpu.index.index_config import DataSkippingIndexConfig
from hyperspace_tpu.plan.expr import col, lit


def _state(reg):
    snap = reg.series_snapshot()
    return snap["counters"], snap["gauges"], snap["histograms"]


def test_counters_gauges_and_histograms_come_back():
    reg = telemetry.get_registry()
    reg.counter("guardtest.old_counter").inc(2)
    reg.gauge("guardtest.old_gauge").set(5)
    reg.histogram("guardtest.old_hist").observe(3.0)
    before = _state(reg)
    with jax_counters_restored():
        reg.counter("guardtest.old_counter").inc(7)
        reg.counter("guardtest.new_counter").inc()
        reg.gauge("guardtest.old_gauge").set(11)
        reg.gauge("guardtest.new_gauge").set(1)
        reg.histogram("guardtest.old_hist").observe(1e6)
        reg.histogram("guardtest.new_hist").observe(0.5)
    assert _state(reg) == before
    # The guarded metrics are the same objects, still live.
    reg.histogram("guardtest.old_hist").observe(3.0)
    assert reg.series_snapshot()["histograms"]["guardtest.old_hist"][
        "count"] == 2


def test_a_served_skipping_query_leaves_the_advisor_assumption(tmp_path):
    src = str(tmp_path / "src")
    os.makedirs(src)
    rng = np.random.default_rng(7)
    for i in range(8):
        pq.write_table(pa.table({
            "key": np.arange(i * 100, (i + 1) * 100, dtype=np.int64),
            "val": rng.random(100)}), os.path.join(src, f"f{i}.parquet"))
    conf = HyperspaceConf({
        "hyperspace.warehouse.dir": str(tmp_path / "wh"),
        "spark.hyperspace.distribution.enabled": "false"})
    reg = telemetry.get_registry()
    before = measured_prune_fraction(conf)
    with jax_counters_restored():
        sess = HyperspaceSession(conf)
        hs = Hyperspace(sess)
        df = sess.read_parquet(src)
        hs.create_index(df, DataSkippingIndexConfig("sk", ["key"]))
        sess.enable_hyperspace()
        q = df.filter(col("key") == lit(250)).select("key", "val")
        assert q.collect().num_rows == 1
        hist = reg.series_snapshot()["histograms"].get(
            "skipping.measured_prune_fraction")
        assert hist and hist["count"] >= 1
        assert measured_prune_fraction(conf)[1] == "measured:global"
    assert measured_prune_fraction(conf) == before
