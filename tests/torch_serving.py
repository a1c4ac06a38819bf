"""Helpers shared by the port's serving-plane parity tests
(`tests/test_torch_{serving,batcher,ingest,resilience,tenancy}.py`).

Each of those tests runs ONE scenario through both packages on the same
seeded lake and compares what came out. `Pkg` gives a scenario one
package's surface under the same names (`P.sched`, `P.batcher`,
`P.faults`, `P.exc`, `P.telemetry`, ...), so a scenario body is written
once and run as `scenario(JAX, ...)` and `scenario(TORCH, ...)`. A port
session is always on the CPU (`device="cpu"`).

- `same_table`: row-for-row equality of two Arrow tables (ints and
  strings exactly, float64 at rtol 1e-12).
- `canonical`: `tests/chaos.py`'s row-order-insensitive form.
- `reset_lanes`: both packages' scheduler and batcher replaced by fresh
  ones, both fault injectors uninstalled, both warm-up memos cleared —
  the `fresh_scheduler`/`fresh_lane` discipline of the JAX suites for
  the two packages at once.
"""

from __future__ import annotations

import importlib
import threading
from types import SimpleNamespace

import numpy as np
import pyarrow as pa

from chaos import canonical  # noqa: F401  (re-exported)
from torch_suites import jax_counters_restored  # noqa: F401  (re-exported)

MIB = 1024 * 1024


class Pkg:
    """One package's surface under package-neutral names."""

    def __init__(self, name: str, root: str):
        self.name = name
        self.root = root

        def m(path):
            return importlib.import_module(f"{root}.{path}")

        self.pkg = importlib.import_module(root)
        self.telemetry = m("telemetry")
        self.sched = m("engine.scheduler")
        self.batcher = m("engine.batcher")
        self.ingest = m("engine.ingest")
        self.exc = m("exceptions")
        self.faults = m("utils.faults")
        self.retry = m("utils.retry")
        self.file_utils = m("utils.file_utils")
        self.footprint = m("plan.footprint")
        self.nodes = m("plan.nodes")
        self.schema = m("plan.schema")
        self.expr = m("plan.expr")
        self.transfer = m("io.transfer")
        self.segcache = m("io.segcache")
        self.constants = m("constants")
        self.pins = m("index.pins")
        self.sketch = m("index.sketch")
        self.log_manager = m("index.log_manager")
        self.log_entry = m("index.log_entry")
        self.data_manager = m("index.data_manager")
        self.flight = m("telemetry.flight")
        self.ops_server = m("telemetry.ops_server")
        self.alerts = m("telemetry.alerts")
        self.registry = m("telemetry.registry")
        self.compilation = m("telemetry.compilation")
        self.actions_base = m("actions.base")
        self.vacuum = m("actions.vacuum")
        facade = m("facade")
        self.Hyperspace = facade.Hyperspace
        self.HyperspaceConf = m("config").HyperspaceConf
        index_config = m("index.index_config")
        self.IndexConfig = index_config.IndexConfig
        self.DataSkippingIndexConfig = index_config.DataSkippingIndexConfig
        self.col = self.expr.col
        self.lit = self.expr.lit
        self.States = self.constants.States
        self.STABLE_STATES = self.constants.STABLE_STATES

    def __repr__(self):
        return self.name

    # -- sessions -----------------------------------------------------------

    def conf(self, values=None):
        return self.HyperspaceConf(
            {k: str(v) for k, v in (values or {}).items()})

    def session(self, values=None):
        session_mod = importlib.import_module(f"{self.root}.engine.session")
        conf = self.conf(values)
        if self.name == "torch":
            return session_mod.HyperspaceSession(conf, device="cpu")
        return session_mod.HyperspaceSession(conf)

    # -- registry -------------------------------------------------------------

    def counter(self, name):
        return self.telemetry.get_registry().counters_dict().get(name, 0)

    def raw_counter(self, name):
        """Unrounded (`counters_dict` rounds to 6 decimals)."""
        return self.telemetry.get_registry().series_snapshot()[
            "counters"].get(name, 0)

    def counters(self, *names):
        c = self.telemetry.get_registry().counters_dict()
        return {n: c.get(n, 0) for n in names}

    def gauge(self, name):
        return self.telemetry.get_registry().gauge(name).value

    # -- scheduler fixtures ---------------------------------------------------

    def entry(self, qid, nbytes, tenant="default", timeout_s=None):
        ent = self.sched._QueryEntry(qid, self.sched.Deadline(qid, timeout_s),
                                     nbytes, None)
        ent.tenant = tenant
        return ent

    def hold(self, sch, nbytes, qid="blocker", tenant="default"):
        """Occupy `nbytes` of the serving budget (a stand-in for a
        long-running admitted query)."""
        ent = self.entry(qid, nbytes, tenant)
        with sch._cv:
            sch._active[qid] = ent
            sch._grant(ent, self.telemetry.get_registry())
        return ent

    def fresh(self):
        """Fresh scheduler and batcher; returns (scheduler, batcher)."""
        sch = self.sched.set_scheduler(self.sched.QueryScheduler())
        bat = self.batcher.set_batcher(self.batcher.QueryBatcher())
        self.faults.uninstall()
        return sch, bat

    def arm(self, *rules, seed=0):
        return self.faults.install(self.faults.FaultInjector(rules,
                                                             seed=seed))

    def rule(self, *args, **kwargs):
        return self.faults.FaultRule(*args, **kwargs)

    def run_chaos(self, *args, **kwargs):
        if self.name == "torch":
            import torch_chaos
            return torch_chaos.run_chaos(*args, **kwargs)
        import chaos
        return chaos.run_chaos(*args, **kwargs)

    def make_entry(self, name="idx", state="ACTIVE", indexed=("clicks",),
                   included=("score",), num_buckets=8,
                   root="/tmp/idx/v__=0"):
        """`tests/fakes.make_entry` in this package's log-entry types."""
        le = self.log_entry
        schema = self.schema.Schema([self.schema.Field(c, "int64")
                                     for c in (*indexed, *included)])
        entry = le.IndexLogEntry(
            name=name,
            derived_dataset=le.CoveringIndex(list(indexed), list(included),
                                             schema.to_json(), num_buckets),
            content=le.Content(root=root, directories=[]),
            source=le.Source(
                plan=le.PlanSource("{}", le.LogicalPlanFingerprint(
                    [le.Signature("test.Provider", "sig")])),
                data=[le.Hdfs(le.Content("", [le.Directory(
                    "", ["f1", "f2"], le.NoOpFingerprint())]))]),
            extra={})
        entry.state = state
        return entry


JAX = Pkg("jax", "hyperspace_tpu")
TORCH = Pkg("torch", "hyperspace_tpu_torch")
PKGS = (JAX, TORCH)


def reset_lanes():
    for P in PKGS:
        P.fresh()
        P.compilation.reset_aot_memo()


def both(scenario, tmp_path, *args, **kwargs):
    """Run `scenario(P, tmp_path / P.name, ...)` for each package;
    returns {"jax": out, "torch": out}."""
    out = {}
    for P in PKGS:
        d = tmp_path / P.name
        d.mkdir(exist_ok=True)
        out[P.name] = scenario(P, d, *args, **kwargs)
    return out


# ---------------------------------------------------------------------------
# Result comparison
# ---------------------------------------------------------------------------


def same_table(a, b, rtol: float = 1e-12) -> bool:
    """Row-for-row equality: same column names and row count; integer,
    string and boolean columns exactly, float columns at `rtol` (NaN
    equal to NaN)."""
    if a.schema.names != b.schema.names or a.num_rows != b.num_rows:
        return False
    for name in a.schema.names:
        x, y = a.column(name), b.column(name)
        if pa.types.is_floating(x.type) or pa.types.is_floating(y.type):
            xv = np.asarray(x.to_pylist(), dtype=object)
            yv = np.asarray(y.to_pylist(), dtype=object)
            xn, yn = xv == None, yv == None  # noqa: E711
            if not np.array_equal(xn, yn):
                return False
            xf = xv[~xn].astype(np.float64)
            yf = yv[~yn].astype(np.float64)
            if not np.allclose(xf, yf, rtol=rtol, atol=0.0, equal_nan=True):
                return False
        elif x.to_pylist() != y.to_pylist():
            return False
    return True


def same_rows(a, b) -> bool:
    """`same_table` over `canonical` (row-order-insensitive) forms."""
    return same_table(canonical(a), canonical(b))


def typed(exc) -> str:
    """A typed outcome by class name (None for a result)."""
    return None if exc is None else type(exc).__name__


def run_threads(fns, join_s: float = 60.0):
    """Run each callable on its own thread; asserts every thread came
    home."""
    threads = [threading.Thread(target=f) for f in fns]
    for th in threads:
        th.start()
    for th in threads:
        th.join(join_s)
    assert not any(th.is_alive() for th in threads), "a thread hung"


def ns(**kw):
    return SimpleNamespace(**kw)
