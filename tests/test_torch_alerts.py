"""Incident plane and durable history of `hyperspace_tpu_torch`
(`telemetry/alerts.py`, `telemetry/history.py`) against the JAX
package: the same scripted gauge and counter ticks make both packages'
`AlertManager`s open and resolve the same incidents on the same ticks
(every rule kind; the serving plane's `burn` kind reads each
package's own scheduler), and
`history.merge` / `trend_report` give equal results on the same segment
files, whichever package wrote them.

Process state: each test starts and ends with no alert manager,
history writer or process sampler installed in EITHER package
(`alerts.reset_manager`, `history.reset_history`,
`timeseries.reset_sampler`), so no test leaves a hook behind for a
later test in the same process; the gauges this file sets are its own
(`testal.*`) and are zeroed after each test.
"""

import json
import os

import numpy as np
import pytest
from torch_suites import jax_counters_guard  # noqa: E402,F401

from hyperspace_tpu import telemetry as jtelemetry
from hyperspace_tpu.config import HyperspaceConf as JConf
from hyperspace_tpu.telemetry import alerts as jalerts
from hyperspace_tpu.telemetry import history as jhistory
from hyperspace_tpu.telemetry import timeseries as jts
import hyperspace_tpu_torch as ths
from hyperspace_tpu_torch import HyperspaceConf, telemetry
from hyperspace_tpu_torch.telemetry import alerts, history, timeseries
from hyperspace_tpu_torch.telemetry.alerts import AlertManager, AlertRule
from hyperspace_tpu_torch.telemetry.history import TelemetryHistory

PACKAGES = ((alerts, history, timeseries), (jalerts, jhistory, jts))


def _reset_all():
    for al, hi, ts in PACKAGES:
        al.reset_manager()
        hi.reset_history()
        ts.reset_sampler()


@pytest.fixture(autouse=True)
def clean_planes():
    _reset_all()
    yield
    _reset_all()
    for reg in (telemetry.get_registry(), jtelemetry.get_registry()):
        for name in list(reg.series_snapshot()["gauges"]):
            if name.startswith("testal."):
                reg.gauge(name).set(0.0)


def _counters(reg, *names):
    c = reg.counters_dict()
    return tuple(c.get(n, 0) for n in names)


def test_default_rules_are_the_jax_packages_but_burn():
    # Since the serving plane is ported, every default rule is the JAX
    # package's, `slo_burn` and the serving and ingest rules included
    # (each reads a series the port's scheduler or ingest coordinator
    # sets); the scripted rules below drive every kind but `burn`,
    # which reads each package's own scheduler.
    want = [r.to_dict() for r in jalerts.DEFAULT_RULES]
    assert [r.to_dict() for r in alerts.DEFAULT_RULES] == want
    assert {r.name for r in alerts.DEFAULT_RULES} >= {
        "slo_burn", "hbm_headroom", "queue_saturation", "breaker_open",
        "ingest_staleness"}
    assert ({r.kind for r in jalerts.DEFAULT_RULES} - {"burn"}
            <= set(KINDS))


# ---------------------------------------------------------------------------
# The same tick script through both packages
# ---------------------------------------------------------------------------

KINDS = ("gauge", "gauge_frac", "window_rate", "window_delta", "hit_ratio",
         "trend")


def _rule(mod, kind, series):
    common = dict(sustain_s=2.0, window_s=4.0, description=f"script {kind}")
    if kind == "gauge":
        return mod.AlertRule("t_gauge", "gauge", series, threshold=50.0,
                             clear=20.0, **common)
    if kind == "gauge_frac":
        return mod.AlertRule("t_frac", "gauge_frac", series, threshold=0.8,
                             clear=0.5, capacity_of=lambda conf: 100.0,
                             **common)
    if kind == "window_rate":
        return mod.AlertRule("t_rate", "window_rate", series,
                             threshold=3.0, clear=1.0, **common)
    if kind == "window_delta":
        return mod.AlertRule("t_delta", "window_delta", series,
                             threshold=8.0, clear=2.0, **common)
    if kind == "hit_ratio":
        return mod.AlertRule("t_ratio", "hit_ratio", series, threshold=0.5,
                             clear=0.7, direction="below", min_count=4,
                             **common)
    return mod.AlertRule("t_trend", "trend", series, threshold=1.5,
                         clear=1.1, **common)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("kind", KINDS)
def test_same_ticks_fire_the_same_incidents(kind, seed):
    series = f"testal.{kind}.s{seed}"
    rng = np.random.default_rng([seed, KINDS.index(kind)])
    sides = []
    for (al, _hi, ts), pkg in zip(PACKAGES, (telemetry, jtelemetry)):
        sampler = ts.TimeSeriesSampler(
            interval_s=1.0, capacity=64, window_s=4.0,
            counter_prefixes=(series,), gauge_prefixes=(series,),
            histogram_prefixes=())
        watched = series + (".g" if kind.startswith("gauge") else ".c")
        manager = al.AlertManager(rules=[_rule(al, kind, watched)])
        sides.append((pkg.get_registry(), sampler, manager))
    before = [_counters(reg, "alerts.fired", "alerts.resolved",
                        "alerts.suppressed") for reg, _s, _m in sides]
    t0 = 10_000.0 + 100 * seed
    fired_any = 0
    for i in range(40):
        level = 1.0 if (i // 8) % 2 else 0.0   # alternating phases
        gauge = float(rng.integers(0, 20) + 85 * level)
        inc = int(rng.integers(0, 3) + 10 * level)
        hits = int(rng.integers(0, 4) + 6 * (1 - level))
        misses = int(rng.integers(0, 4) + 6 * level)
        transitions = []
        for reg, sampler, manager in sides:
            reg.gauge(f"{series}.g").set(gauge)
            reg.counter(f"{series}.c").inc(inc)
            reg.counter(f"{series}.c.hits").inc(hits)
            reg.counter(f"{series}.c.misses").inc(misses)
            sampler.tick(t=t0 + i)
            got = manager.evaluate(sampler=sampler, now=t0 + i)
            transitions.append([
                {k: inc_.get(k) for k in ("rule", "state", "opened_at",
                                          "resolved_at", "value",
                                          "resolved_value", "threshold",
                                          "clear", "description")}
                for inc_ in got])
        assert transitions[0] == transitions[1], (i, transitions)
        fired_any += sum(1 for t in transitions[0]
                         if t["state"] == "firing")
    assert fired_any > 0
    after = [_counters(reg, "alerts.fired", "alerts.resolved",
                       "alerts.suppressed") for reg, _s, _m in sides]
    deltas = [tuple(a - b for a, b in zip(x, y))
              for x, y in zip(after, before)]
    assert deltas[0] == deltas[1]
    ours, theirs = (m for _r, _s, m in sides)
    assert ours.digest()["active"] == theirs.digest()["active"]
    assert [(i["rule"], i["state"]) for i in ours.incidents()] == \
        [(i["rule"], i["state"]) for i in theirs.incidents()]


def test_sustain_and_hysteresis_lifecycle():
    reg = telemetry.get_registry()
    g = reg.gauge("testal.life")
    m = AlertManager(rules=[AlertRule(
        "t_life", "gauge", "testal.life", threshold=10.0, clear=5.0,
        sustain_s=3.0, description="scripted")])
    ev0, f0, r0, s0 = _counters(reg, "alerts.evaluations", "alerts.fired",
                                "alerts.resolved", "alerts.suppressed")
    g.set(20.0)
    assert m.evaluate(now=100.0) == []
    g.set(4.0)
    assert m.evaluate(now=101.0) == []      # hiccup resets the clock
    g.set(20.0)
    assert m.evaluate(now=102.0) == []
    assert m.evaluate(now=104.9) == []
    (fired,) = m.evaluate(now=105.1)
    assert fired["state"] == "firing" and m.active_count() == 1
    g.set(7.0)
    assert m.evaluate(now=106.0) == []      # hysteresis band
    g.set(20.0)
    assert m.evaluate(now=107.0) == []      # suppressed
    g.set(4.0)
    (resolved,) = m.evaluate(now=108.0)
    assert resolved["id"] == fired["id"] and resolved["resolved_at"] == 108.0
    ev, f, r, s = _counters(reg, "alerts.evaluations", "alerts.fired",
                            "alerts.resolved", "alerts.suppressed")
    assert (ev - ev0, f - f0, r - r0, s - s0) == (8, 1, 1, 1)
    assert reg.to_dict()["gauges"]["alerts.active"] == 0


def test_conf_overrides_disable_and_retune():
    reg = telemetry.get_registry()
    reg.gauge("testal.tune").set(20.0)
    rule = AlertRule("t_tune", "gauge", "testal.tune", threshold=10.0,
                     clear=5.0, description="tunable")
    prefix = "spark.hyperspace.telemetry.alerts."
    off = HyperspaceConf({prefix + "rule.t_tune.enabled": "false"})
    assert AlertManager(rules=[rule]).evaluate(conf=off, now=1.0) == []
    tuned = HyperspaceConf({prefix + "rule.t_tune.threshold": "50"})
    m = AlertManager(rules=[rule])
    assert m.evaluate(conf=tuned, now=1.0) == []
    reg.gauge("testal.tune").set(60.0)
    assert len(m.evaluate(conf=tuned, now=2.0)) == 1
    killed = HyperspaceConf({prefix + "enabled": "false"})
    assert AlertManager(rules=[rule]).evaluate(conf=killed, now=1.0) == []


def test_evidence_bundle_and_incident_persistence(tmp_path):
    hist_dir = tmp_path / "hist"
    history.set_history(TelemetryHistory(str(hist_dir), interval_s=1.0))
    qm = telemetry.QueryMetrics("slowest")
    qm.finish()
    qm.critical_path = {"wall_s": 0.05, "segments": {"host_python": 0.05}}
    telemetry.flight.get_recorder().record(qm)
    reg = telemetry.get_registry()
    m = alerts.set_manager(AlertManager(rules=[AlertRule(
        "t_ev", "gauge", "testal.ev", threshold=1.0, clear=0.5,
        description="evidence")]))
    try:
        reg.gauge("testal.ev").set(5.0)
        (incident,) = m.evaluate(now=50.0)
        ev = incident["evidence"]
        assert set(ev) == {"captured_at", "registry", "window_quantiles",
                           "flight", "slowlog", "slo", "device_profile"}
        assert ev["slowlog"]["kind"] == "hyperspace-slowlog"
        assert ev["flight"][-1]["critical_path"]["segments"]
        assert ev["device_profile"] is None   # capture not armed
        reg.gauge("testal.ev").set(0.0)
        m.evaluate(now=51.0)
        segs, skipped = history.read_segments(str(hist_dir))
        assert skipped == 0
        assert [s["incidents"][0]["state"] for s in segs] == \
            ["firing", "resolved"]
        assert set(segs[0]["slo"]) >= {"window_queries", "burn_rate"}
        hs = ths.Hyperspace(ths.HyperspaceSession(HyperspaceConf({
            "spark.hyperspace.warehouse.dir": str(tmp_path / "wh")}),
            device="cpu"))
        assert [i["id"] for i in hs.incidents()] == [incident["id"]]
        assert hs.incidents(active_only=True) == []
        doc = alerts.alerts_doc()
        assert doc["recent"][-1]["state"] == "resolved"
    finally:
        telemetry.flight.get_recorder().clear()


# ---------------------------------------------------------------------------
# Durable history through both packages
# ---------------------------------------------------------------------------


def _write_segments(directory, seed):
    """Segments from both packages' writers into one directory, each
    with its own sampler samples and an incident the other resolves."""
    rng = np.random.default_rng(seed)
    incident = {"id": f"inc-{seed}-0001", "rule": "t_hist",
                "state": "firing", "opened_at": 1000.0, "resolved_at": None,
                "value": 2.0, "threshold": 1.0}
    writers = []
    for (al, hi, ts), pkg, conf in (
            (PACKAGES[0], telemetry, HyperspaceConf()),
            (PACKAGES[1], jtelemetry, JConf())):
        sampler = ts.set_sampler(ts.TimeSeriesSampler(
            interval_s=1.0, capacity=64, counter_prefixes=("testal.",),
            gauge_prefixes=("testal.",)))
        writers.append((hi, pkg, sampler, conf))
    t = 1000.0
    for step in range(6):
        hi, pkg, sampler, conf = writers[step % 2]
        reg = pkg.get_registry()
        reg.counter("testal.hist.count").inc(int(rng.integers(1, 9)))
        reg.histogram("query.wall_s").observe(float(rng.random()))
        sampler.tick(t=t)
        sampler.tick(t=t + 1.0)
        state = incident if step < 3 else dict(
            incident, state="resolved", resolved_at=t)
        hi.TelemetryHistory(str(directory)).flush(
            conf=conf, reason="incident", now=t + 1.5, incidents=[state])
        t += 100.0


@pytest.mark.parametrize("seed", range(3))
def test_merge_and_trend_report_equal_jax(tmp_path, seed):
    d = tmp_path / "hist"
    _write_segments(d, seed)
    merged = history.merge(str(d))
    assert merged == jhistory.merge(str(d))
    assert merged["segments"] == 6
    assert [i["state"] for i in merged["incidents"]] == ["resolved"]
    for window in (50.0, 300.0, 5000.0):
        for series in (None, ["testal."], ["query.wall_s"]):
            assert history.trend_report(merged, window_s=window,
                                        series=series) == \
                jhistory.trend_report(merged, window_s=window,
                                      series=series)
    base = {"metric": "m", "driver": "d",
            "process_metrics": {"testal.hist.count": 1.0}}
    assert history.trend_report(merged, baseline=base) == \
        jhistory.trend_report(merged, baseline=base)


def test_torn_and_foreign_segments_are_skipped(tmp_path):
    d = tmp_path / "hist"
    h = TelemetryHistory(str(d), interval_s=1.0)
    assert h.flush(reason="manual", now=1000.0)
    assert h.flush(reason="manual", now=1100.0)
    (d / "history-1200000-42-000003.json").write_text(
        '{"kind": "hyperspace-telemetry-history", "schema_ver')
    (d / "history-1300000-42-000004.json").write_text('{"kind": "other"}')
    (d / "history-1400000-42-000005.json.tmp").write_text("{")
    segs, skipped = history.read_segments(str(d))
    assert [s["written_at"] for s in segs] == [1000.0, 1100.0]
    assert skipped == 2
    assert history.merge(str(d))["skipped"] == 2


def test_byte_budget_keeps_the_newest(tmp_path):
    d = tmp_path / "hist"
    h = TelemetryHistory(str(d), interval_s=1.0, keep_seconds=0,
                         keep_bytes=1)
    for t in (1000.0, 1001.0, 1002.0):
        h.flush(reason="manual", now=t)
    names = [f for f in os.listdir(str(d)) if f.endswith(".json")]
    assert len(names) == 1 and names[0].startswith("history-1002000-")


def test_cli_report_over_the_merged_history(tmp_path, capsys):
    d = tmp_path / "hist"
    _write_segments(d, 0)
    assert history._main(["report", "--dir", str(d), "--series",
                          "testal."]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["segments"] == 6 and len(doc["writers"]) == 1
    assert "testal.hist.count" in doc["counters"]
    assert doc["incident_list"][0]["state"] == "resolved"
    assert history._main([]) == 2


def test_configure_installs_the_writer_only_when_enabled(tmp_path):
    assert history.configure(HyperspaceConf()) is None
    conf = HyperspaceConf({
        "spark.hyperspace.warehouse.dir": str(tmp_path / "wh"),
        "spark.hyperspace.telemetry.history.enabled": "true",
        "spark.hyperspace.telemetry.history.interval.seconds": "5"})
    h = history.configure(conf)
    assert h is history.get_history()
    assert h.directory == str(tmp_path / "wh" / ".hyperspace_telemetry")
    assert h.interval_s == 5.0
    assert h.maybe_flush(conf=conf, now=10.0)
    assert h.maybe_flush(conf=conf, now=12.0) is None   # interval-gated
