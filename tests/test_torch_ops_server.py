"""Ops server of `hyperspace_tpu_torch` (`telemetry/ops_server.py`): the
JAX package's endpoints at the same paths on an ephemeral port —
`/metrics`, `/healthz`, `/timeseries` (with its `since` cursor),
`/critpath`, `/alerts` and `/profile` — the `/healthz` document with
the JAX package's sections, replica routing included, and session-init
wiring.

Process state: each test starts and ends with no port ops server, alert
manager, history writer or process sampler (`ops_server.stop_server`,
`alerts.reset_manager`, `history.reset_history`,
`timeseries.reset_sampler`) and an empty port flight ring; every server
is stopped in the fixture, so no listener or thread outlives a test.
"""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
from torch_suites import jax_counters_guard  # noqa: E402,F401

from hyperspace_tpu.telemetry import ops_server as jops
import hyperspace_tpu_torch as ths
from hyperspace_tpu_torch.telemetry import (alerts, flight, history,
                                            ops_server, timeseries)


def _reset():
    ops_server.stop_server()
    alerts.reset_manager()
    history.reset_history()
    timeseries.reset_sampler()
    flight.get_recorder().clear()


@pytest.fixture(autouse=True)
def clean_ops_plane():
    _reset()
    yield
    _reset()
    assert not [t for t in threading.enumerate()
                if t.name in ("hs-ops-server", "hs-timeseries")
                and t.is_alive()]


@pytest.fixture
def server():
    return ops_server.start_server(port=0)


def _get(server, path):
    url = f"http://127.0.0.1:{server.port}{path}"
    with urllib.request.urlopen(url, timeout=30) as r:
        return r.status, r.headers.get("Content-Type"), r.read()


@pytest.fixture
def lake(tmp_path):
    rng = np.random.default_rng(9)
    src = tmp_path / "src"
    src.mkdir()
    pq.write_table(pa.table({"k": rng.integers(0, 200, 4000),
                             "v": rng.random(4000)}),
                   str(src / "part-0.parquet"))
    sess = ths.HyperspaceSession(ths.HyperspaceConf({
        "spark.hyperspace.warehouse.dir": str(tmp_path / "wh"),
        "spark.hyperspace.execution.min.device.rows": "0",
        "spark.hyperspace.telemetry.ops.port": "0",
        "spark.hyperspace.telemetry.timeseries.interval.seconds": "3600",
    }), device="cpu")
    hs = ths.Hyperspace(sess)
    df = sess.read_parquet(str(src))
    hs.create_index(df, ths.IndexConfig("kIdx", ["k"], ["v"]))
    hs.create_index(df, ths.IndexConfig("idleIdx", ["v"], ["k"]))
    sess.enable_hyperspace()
    return sess, hs, df


def test_session_starts_the_server_and_every_endpoint_answers(lake):
    sess, hs, df = lake
    server = ops_server.get_server()
    assert server is not None and server.running and server.port > 0
    assert server.host == "127.0.0.1"
    df.filter(ths.col("k") < 20).select("k", "v").collect()
    status, ctype, body = _get(server, "/metrics")
    assert status == 200 and ctype == ops_server.PROM_CONTENT_TYPE
    text = body.decode()
    assert "device_bytes_accessed" in text and "queries_total" in text
    for path in ("/healthz", "/timeseries", "/critpath", "/alerts",
                 "/profile"):
        status, ctype, body = _get(server, path)
        assert status == 200 and ctype == "application/json", path
        json.loads(body)
    status, ctype, body = _get(server, "/profile?format=collapsed")
    assert status == 200 and ctype.startswith("text/plain")
    with pytest.raises(urllib.error.HTTPError) as err:
        _get(server, "/nope")
    assert err.value.code == 404


def test_healthz_document(lake):
    sess, hs, df = lake
    df.filter(ths.col("k") < 20).select("k", "v").collect()
    _status, _ctype, body = _get(ops_server.get_server(), "/healthz")
    doc = json.loads(body)
    assert set(doc) == {"status", "time", "uptime_s", "scheduler",
                        "breakers", "segments", "replicas", "flight",
                        "tenants", "incidents", "index_usage"}
    assert doc["status"] == "ok"
    assert doc["flight"]["ring"] == 1
    assert doc["flight"]["by_tenant"] == {"default": 1}
    # One device, so the collect was not routed.
    assert doc["flight"]["by_replica"] == {"unrouted": 1}
    assert doc["incidents"]["active"] == []
    usage = {r["index"]: r for r in doc["index_usage"]["indexes"]}
    assert usage["kIdx"]["served_total"] >= 1
    assert doc["index_usage"]["unused"] == ["idleIdx"]
    assert usage == {r["index"]: r for r in hs.index_usage()}
    # The serving-plane sections (the JAX package's): scheduler
    # pressure with the SLO window, breakers, tenants with their usage.
    assert doc["scheduler"]["queue_depth"] == 0
    assert "slo" in doc["scheduler"]
    assert isinstance(doc["breakers"], dict)
    assert "usage" in doc["tenants"]["default"]
    # The replica section is present (not an error stub) and keyed as
    # the JAX package's.
    assert set(doc["replicas"]) == {"routed", "inflight", "admitted_bytes"}


def test_healthz_sections_are_a_subset_of_the_jax_packages():
    ours = ops_server.healthz_doc()
    theirs = jops.healthz_doc()
    assert set(ours) == set(theirs)
    assert set(ours["replicas"]) == set(theirs["replicas"])
    assert set(ours["flight"]) == set(theirs["flight"])


def test_timeseries_since_cursor(server):
    sampler = timeseries.get_sampler()
    for i in range(5):
        sampler.tick(t=1000.0 + i)
    doc = json.loads(_get(server, "/timeseries")[2])
    assert doc["last_seq"] == 5 and len(doc["samples"]) == 5
    doc = json.loads(_get(server, "/timeseries?since=3")[2])
    assert [s["seq"] for s in doc["samples"]] == [4, 5]
    doc = json.loads(_get(server, "/timeseries?since=bogus")[2])
    assert len(doc["samples"]) == 5


def test_critpath_serves_window_and_recent(server, lake):
    sess, hs, df = lake
    for _ in range(2):
        df.filter(ths.col("k") < 20).select("k", "v").collect()
    doc = json.loads(_get(server, "/critpath")[2])
    assert set(doc) == {"window", "recent", "totals"}
    assert len(doc["recent"]) == 2
    assert doc["recent"][0]["critical_path"]["dominant"]
    assert doc["totals"]["critpath.queries"] >= 2


def test_alerts_endpoint_serves_the_rule_table(server):
    doc = json.loads(_get(server, "/alerts")[2])
    assert [r["name"] for r in doc["rules"]] == \
        [r.name for r in alerts.DEFAULT_RULES]
    assert set(doc["counters"]) == {"alerts.evaluations", "alerts.fired",
                                    "alerts.resolved", "alerts.suppressed"}


def test_unset_port_starts_nothing_and_stop_is_idempotent():
    assert ops_server.configure(ths.HyperspaceConf()) is None
    s = ops_server.start_server(port=0)
    assert ops_server.start_server(port=0) is s
    ops_server.stop_server()
    ops_server.stop_server()
    assert ops_server.get_server() is None and not s.running
