"""The live operations endpoint: an in-process, pull-based HTTP server.

The source paper's design keeps all index state on the lake with no
side services; the operations plane keeps the same discipline — no
agent, no push gateway, no sidecar. When
`spark.hyperspace.telemetry.ops.port` is set, a stdlib
`ThreadingHTTPServer` starts inside the engine process (the ONE
`http.server` use of the package) and serves the JAX package's six
read-only endpoints, at the same paths:

- **`/metrics`** — the registry's Prometheus text exposition
  (`MetricsRegistry.to_text()`), including the sampler's
  `window.<series>.*` sliding-window gauges and the
  `device.*` / `compile.*` counters of the compile and launch seam. A
  scrape first takes a fresh sampler tick when the last one is older
  than the sampling interval, so the window gauges a scraper reads are
  never staler than its own scrape period.
- **`/healthz`** — one JSON document of serving-plane state: scheduler
  pressure and SLO burn, per-index breaker states, segment-cache
  residency, replica routing (routed counts, in-flight counts and
  admitted bytes per replica slice, `parallel/replica.py`), per-tenant
  admission and usage, the flight ring grouped by replica and by
  tenant, the incident plane, and the per-index usage report — the JAX
  package's sections.
- **`/timeseries`** — the sampler's ring as JSON (the raw material of
  the `/metrics` window gauges, for dashboards that want the history
  rather than the trailing point). `?since=<seq>` returns only ticks
  newer than the caller's cursor — the flight recorder's
  `snapshot(since_seq)` contract, so incremental scrapers stop
  re-downloading the whole ring; `last_seq` in the payload is the next
  cursor.
- **`/critpath`** — the latency anatomy
  (`telemetry/critical_path.py`): trailing-window segment shares of
  query wall plus the per-query decompositions of the flight ring's
  recent entries.
- **`/profile`** — the sampling profiler (`telemetry/profiler.py`):
  host-time tables, flamegraph JSON (or `?format=collapsed` for the
  flamegraph.pl/speedscope text form), and the recent triggered
  device captures.
- **`/alerts`** — the incident plane (`telemetry/alerts.py`): the
  conf-resolved rule table, active and recent incidents with their
  evidence bundles, and the exact
  `alerts.{evaluations,fired,resolved,suppressed}` counters.

Security: the server binds `telemetry.ops.host` — 127.0.0.1 by
default. The endpoints are unauthenticated, read-only operational
surfaces; binding beyond localhost is an explicit operator decision
(front it with real auth if you do). Request-handler errors are
counted (`ops.http.errors`), never raised into serving threads.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from hyperspace_tpu_torch.telemetry import registry as _registry
from hyperspace_tpu_torch.telemetry import timeseries as _timeseries

__all__ = ["OpsServer", "get_server", "start_server", "stop_server",
           "configure", "healthz_doc", "critpath_doc"]

PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

# The last conf handed to configure(): healthz sections that need conf
# context (the index-usage report) read it, because an HTTP handler
# thread has no session in hand.
_conf = None


def healthz_doc() -> dict:
    """The `/healthz` payload, assembled defensively: each section
    degrades to an `{"error": ...}` stub rather than failing the whole
    health read — a health endpoint that 500s because one subsystem is
    mid-teardown would be lying about everything else."""
    doc: dict = {"status": "ok",
                 "time": round(time.time(), 3),
                 "uptime_s": round(
                     time.time()
                     - _registry.get_registry().started_at, 3)}

    def section(name, fn):
        try:
            doc[name] = fn()
        except Exception as exc:
            doc[name] = {"error": repr(exc)}

    def _scheduler():
        from hyperspace_tpu_torch.engine.scheduler import get_scheduler
        sched = get_scheduler()
        out = sched.pressure()
        out["active_queries"] = sched.active_queries()
        out["peak_admitted_bytes"] = sched.peak_admitted_bytes
        out["slo"] = sched.slo_snapshot()
        return out

    def _breakers():
        from hyperspace_tpu_torch.engine.scheduler import get_scheduler
        return get_scheduler().breakers.snapshot()

    def _segments():
        from hyperspace_tpu_torch.io import segcache
        return segcache.get_cache().snapshot()

    def _replicas():
        from hyperspace_tpu_torch.engine.scheduler import get_scheduler
        from hyperspace_tpu_torch.parallel import replica as _replica
        sched = get_scheduler()
        return {
            "routed": _replica.get_router().routed_counts(),
            "inflight": sched.replica_inflight(),
            "admitted_bytes": sched.replica_admitted_bytes(),
        }

    def _flight():
        from hyperspace_tpu_torch.telemetry import flight
        rec = flight.get_recorder()
        entries = rec.queries()
        by_replica: dict = {}
        by_tenant: dict = {}
        for qm in entries:
            key = getattr(qm, "replica", None)
            key = "unrouted" if key is None else str(key)
            by_replica[key] = by_replica.get(key, 0) + 1
            t = getattr(qm, "tenant", None) or "default"
            by_tenant[t] = by_tenant.get(t, 0) + 1
        return {"ring": len(entries), "last_seq": rec.last_seq,
                "by_replica": by_replica, "by_tenant": by_tenant}

    def _tenants():
        from hyperspace_tpu_torch.engine.scheduler import get_scheduler
        from hyperspace_tpu_torch.telemetry import tenant_digest
        sched = get_scheduler()
        out = sched.tenant_snapshot()
        for t, usage in tenant_digest().items():
            out.setdefault(t, {})["usage"] = usage
        return out

    def _incidents():
        from hyperspace_tpu_torch.telemetry import alerts
        m = alerts.get_manager()
        counters = _registry.get_registry().counters_dict()
        return {
            "active": [
                {k: i.get(k) for k in ("id", "rule", "series", "state",
                                       "opened_at", "value",
                                       "threshold", "description")}
                for i in m.incidents(active_only=True)],
            "fired": int(counters.get("alerts.fired", 0)),
            "resolved": int(counters.get("alerts.resolved", 0)),
        }

    def _index_usage():
        if _conf is None:
            return {"skipped": "no configured session in this process"}
        from hyperspace_tpu_torch.facade import index_usage_report
        from hyperspace_tpu_torch.index.manager import \
            CachingIndexCollectionManager
        rows = index_usage_report(CachingIndexCollectionManager(_conf))
        return {"indexes": rows,
                "unused": [r["index"] for r in rows if r["unused"]]}

    section("scheduler", _scheduler)
    section("breakers", _breakers)
    section("segments", _segments)
    section("replicas", _replicas)
    section("flight", _flight)
    section("tenants", _tenants)
    section("incidents", _incidents)
    section("index_usage", _index_usage)
    return doc


def critpath_doc(recent: int = 10) -> dict:
    """The `/critpath` payload: trailing-window segment shares (the
    sampler's view) plus the stamped per-query decompositions of the
    flight ring's newest entries — totals AND exemplars in one read."""
    from hyperspace_tpu_torch.telemetry import critical_path, flight
    doc: dict = {"window": critical_path.window_shares()}
    entries = []
    for qm in flight.get_recorder().queries(n=recent):
        cp = getattr(qm, "critical_path", None)
        if cp is None:
            continue
        entries.append({"description": qm.description,
                        "flight_seq": getattr(qm, "flight_seq", None),
                        "tenant": getattr(qm, "tenant", None),
                        "critical_path": cp})
    doc["recent"] = entries
    reg = _registry.get_registry()
    totals = reg.counters_dict()
    doc["totals"] = {k: round(v, 6) for k, v in totals.items()
                    if k.startswith("critpath.")}
    return doc


class _Handler(BaseHTTPRequestHandler):
    server_version = "hyperspace-ops/1"

    # BaseHTTPRequestHandler logs every request to stderr by default;
    # a scraper polling at 15s would spam the serving process's logs.
    def log_message(self, fmt, *args):  # noqa: A003
        pass

    def _send(self, status: int, content_type: str, body: bytes) -> None:
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802
        reg = _registry.get_registry()
        path = self.path.split("?", 1)[0]
        try:
            if path == "/metrics":
                from hyperspace_tpu_torch.telemetry import compilation
                compilation.resolve_pending()
                self._fresh_tick()
                body = reg.to_text().encode("utf-8")
                self._send(200, PROM_CONTENT_TYPE, body)
            elif path == "/healthz":
                body = json.dumps(healthz_doc(),
                                  default=str).encode("utf-8")
                self._send(200, "application/json", body)
            elif path == "/timeseries":
                since = self._since_param()
                body = json.dumps(
                    _timeseries.get_sampler().snapshot(since_seq=since),
                    default=str).encode("utf-8")
                self._send(200, "application/json", body)
            elif path == "/alerts":
                from hyperspace_tpu_torch.telemetry import alerts
                body = json.dumps(alerts.alerts_doc(),
                                  default=str).encode("utf-8")
                self._send(200, "application/json", body)
            elif path == "/critpath":
                self._fresh_tick()
                body = json.dumps(critpath_doc(),
                                  default=str).encode("utf-8")
                self._send(200, "application/json", body)
            elif path == "/profile":
                from hyperspace_tpu_torch.telemetry import profiler
                query = self.path.partition("?")[2]
                if "format=collapsed" in query:
                    p = profiler.get_profiler()
                    text = p.collapsed() if p is not None else ""
                    self._send(200, "text/plain; charset=utf-8",
                               text.encode("utf-8"))
                else:
                    body = json.dumps(profiler.profile_doc(),
                                      default=str).encode("utf-8")
                    self._send(200, "application/json", body)
            else:
                self._send(404, "text/plain; charset=utf-8",
                           b"not found: /metrics /healthz /timeseries "
                           b"/critpath /profile /alerts\n")
            reg.counter("ops.http.requests").inc()
        except Exception:
            reg.counter("ops.http.errors").inc()
            try:
                self._send(500, "text/plain; charset=utf-8",
                           b"internal error\n")
            except Exception:
                pass  # client gone mid-write

    def _since_param(self) -> Optional[int]:
        """The `?since=<seq>` cursor, or None when absent/malformed (a
        bad cursor degrades to the full ring, never a 4xx — same
        lenience as the flight recorder's filters)."""
        from urllib.parse import parse_qs
        query = self.path.partition("?")[2]
        try:
            values = parse_qs(query).get("since")
            return int(values[0]) if values else None
        except (ValueError, TypeError):
            return None

    @staticmethod
    def _fresh_tick() -> None:
        """Refresh the window gauges when the last sample is older
        than one interval — a scrape always reads a current window,
        even if the background thread was never started."""
        sampler = _timeseries.get_sampler()
        latest = sampler._latest()
        if latest is None or time.time() - latest.t >= sampler.interval_s:
            sampler.tick()


class OpsServer:
    """Lifecycle wrapper around the ThreadingHTTPServer: bind, serve on
    one daemon thread (handlers each get their own daemon thread from
    ThreadingHTTPServer), stop idempotently."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self.host = host
        self._requested_port = int(port)
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> Optional[int]:
        """The BOUND port (meaningful for ephemeral port 0)."""
        return self._httpd.server_address[1] \
            if self._httpd is not None else None

    @property
    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def start(self) -> "OpsServer":
        if self.running:
            return self
        httpd = ThreadingHTTPServer((self.host, self._requested_port),
                                    _Handler)
        httpd.daemon_threads = True
        self._httpd = httpd
        self._thread = threading.Thread(target=httpd.serve_forever,
                                        name="hs-ops-server",
                                        daemon=True)
        self._thread.start()
        _registry.get_registry().gauge("ops.server.port").set(self.port)
        return self

    def stop(self) -> None:
        httpd, self._httpd = self._httpd, None
        thread, self._thread = self._thread, None
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        if thread is not None and thread is not threading.current_thread():
            thread.join(timeout=5.0)


# ---------------------------------------------------------------------------
# Process-wide server
# ---------------------------------------------------------------------------

_server: Optional[OpsServer] = None
_server_lock = threading.Lock()


def get_server() -> Optional[OpsServer]:
    return _server


def start_server(host: str = "127.0.0.1", port: int = 0) -> OpsServer:
    """Start (or return) THE process ops server. A second start with a
    different port is ignored with a warning — the server is process-
    wide, same caveat as the transfer-engine knobs."""
    global _server
    with _server_lock:
        if _server is not None and _server.running:
            if port not in (0, _server.port) or host != _server.host:
                import logging
                logging.getLogger(__name__).warning(
                    "ops server already bound to %s:%s; ignoring "
                    "request for %s:%s", _server.host, _server.port,
                    host, port)
            return _server
        _server = OpsServer(host=host, port=port).start()
        return _server


def stop_server() -> None:
    global _server
    with _server_lock:
        server, _server = _server, None
    if server is not None:
        server.stop()


def configure(conf) -> Optional[OpsServer]:
    """Session-init wiring (next to `transfer.configure` and
    `configure_persistent_cache`): configures the sampling profiler,
    the alert manager and the history writer, then, when `telemetry.ops.port` is set,
    start the sampler and the server; unset = no-op. Failures degrade
    to a warning — the operations plane is an observability feature,
    never a startup failure."""
    global _conf
    if conf is not None:
        _conf = conf
    # The sampling profiler, alert manager, and history writer all
    # configure independently of the ops port — an operator can alert
    # and persist history without exposing HTTP (and vice versa).
    try:
        from hyperspace_tpu_torch.telemetry import profiler as _profiler
        _profiler.configure(conf)
    except Exception:
        pass  # profiler.configure logs its own failures
    try:
        from hyperspace_tpu_torch.telemetry import alerts as _alerts
        _alerts.configure(conf)
    except Exception:
        pass  # alerts.configure logs its own failures
    try:
        from hyperspace_tpu_torch.telemetry import history as _history
        _history.configure(conf)
    except Exception:
        pass  # history.configure logs its own failures
    try:
        port = conf.telemetry_ops_port if conf is not None else None
    except Exception:
        port = None
    if port is None:
        return _server
    try:
        _timeseries.configure(conf)
        return start_server(host=conf.telemetry_ops_host, port=port)
    except Exception:
        import logging
        logging.getLogger(__name__).warning(
            "ops server failed to start; operations endpoints "
            "disabled", exc_info=True)
        return None


def _atexit_stop() -> None:
    try:
        stop_server()
    except Exception:
        pass


import atexit  # noqa: E402

atexit.register(_atexit_stop)
