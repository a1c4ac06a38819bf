"""One run of one cell: set-up, a timed window of query streams, the
comparison with the plain reference, and the result line.

Set-up writes the configuration's lake from the seed, loads the port's
kernels, builds every index of the configuration and runs each query of
the mix once. The window then drives `DataFrame.collect()` from one
client thread per stream, each a closed loop over its own order of the
mix, until `--seconds` have passed; the queries in flight at that moment
run to their end and the window closes when the last of them does. Once
it has closed, the program's state is freed and every result returned in
the window is compared with the reference's result for its query.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import glob
import json
import os
import shutil
import subprocess
import sys
import threading
import time
import traceback
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from benchmark import spec, stats, streams
from benchmark.devtrace import Capture, Trace

FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "hyperspace_tpu")
TRACE_STRETCH = (0.25, 0.75)    # the window's share that `--trace 1` profiles
PROFILER_SETTLE_S = 1.0         # the profiler runs this long before the stretch


@dataclass
class Record:
    query: str
    start: float               # perf_counter seconds
    end: float
    table: object = None       # the Arrow table the port returned
    error: Optional[str] = None


@dataclass
class Readings:
    """What a per-layer metric reader gets: window deltas of the port's
    registry, the traced stretches and the sizes they need."""
    completed: int
    window_s: float
    counters: Dict[str, float]
    histograms: Dict[str, dict]
    window_trace: Optional[Trace]
    build_trace: Optional[Trace]
    build_s: float
    index_keys: Dict[str, Tuple[int, int]]     # index -> (rows, key lanes)
    device_kind: str


@dataclass
class Spans:
    """The benchmark's own spans, (name, start_ns, end_ns) on the host
    clock, from every thread."""
    items: List[Tuple[str, int, int]] = field(default_factory=list)
    lock: threading.Lock = field(default_factory=threading.Lock)

    @contextlib.contextmanager
    def __call__(self, name: str):
        start = time.time_ns()
        try:
            yield
        finally:
            with self.lock:
                self.items.append((name, start, time.time_ns()))


def data_seed(seed: int) -> int:
    """The generators take a seed in [0, 2**63)."""
    return int(seed) % (2 ** 63)


def forbidden_modules() -> List[str]:
    loaded = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(loaded.intersection(FORBIDDEN_MODULES))


def card() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
            else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def load_kernels(device) -> None:
    """Load (building on a checkout's first run) the port's CUDA kernels
    and its native host library, so that nothing builds later."""
    if device.type != "cuda":
        return
    from hyperspace_tpu_torch import native
    from hyperspace_tpu_torch.ops.cuda import build as kbuild

    kbuild.build_all()
    for name in kbuild.SOURCES:
        kbuild.load(name)
    if native.get_lib() is None:
        raise RuntimeError("the port's native host library did not load")


def lake_tables(paths: Dict[str, str]):
    """The lake as pandas frames, read straight from its files."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    out = {}
    for name, path in paths.items():
        files = sorted(glob.glob(os.path.join(path, "*.parquet")))
        out[name] = pa.concat_tables(
            [pq.read_table(f, partitioning=None) for f in files]).to_pandas()
    return out


def index_keys(paths, index_defs, names) -> Dict[str, Tuple[int, int]]:
    """Rows and hashed key lanes of each index, from the lake's footers."""
    import pyarrow.parquet as pq

    from benchmark import roofline

    out = {}
    for name in names:
        table, (indexed, _included) = index_defs[name]
        files = sorted(glob.glob(os.path.join(paths[table], "*.parquet")))
        schema = pq.read_schema(files[0])
        rows = sum(pq.ParquetFile(f).metadata.num_rows for f in files)
        out[name] = (rows, sum(roofline.key_lanes(schema.field(c).type)
                               for c in indexed))
    return out


def registry_state():
    from hyperspace_tpu_torch import telemetry
    return telemetry.get_registry().series_snapshot()


def deltas(before: dict, after: dict):
    counters = {k: v - before["counters"].get(k, 0.0)
                for k, v in after["counters"].items()}
    hists = {}
    for k, h in after["histograms"].items():
        b = before["histograms"].get(k, {"count": 0, "sum": 0.0})
        hists[k] = {"count": h["count"] - b["count"],
                    "sum": h["sum"] - b["sum"]}
    return counters, hists


def drive(builders, dfs, orders, seconds: float, spans: Spans,
          capture: Optional[Capture]) -> Tuple[List[Record], float, float]:
    """The window: one closed-loop client per stream. Returns the records,
    and the window's start and end (perf_counter seconds)."""
    records: List[Record] = []
    lock = threading.Lock()
    begin = time.perf_counter()
    deadline = begin + seconds

    def client(stream: int) -> None:
        order = orders[stream]
        k = 0
        while True:
            start = time.perf_counter()
            if start >= deadline:
                return
            query = order[k % len(order)]
            k += 1
            rec = Record(query, start, start)
            try:
                with spans(f"collect:{query}"):
                    rec.table = builders[query](dfs).collect()
            except Exception:  # a failed query is counted, the loop goes on
                rec.error = traceback.format_exc(limit=8)
            rec.end = time.perf_counter()
            with lock:
                records.append(rec)

    threads = [threading.Thread(target=client, args=(i,),
                                name=f"bench-stream-{i}")
               for i in range(len(orders))]
    for t in threads:
        t.start()
    if capture is not None:
        stretch = [begin + seconds * share for share in TRACE_STRETCH]
        time.sleep(max(0.0, stretch[0] - PROFILER_SETTLE_S
                       - time.perf_counter()))
        capture.start()
        time.sleep(max(0.0, stretch[0] - time.perf_counter()))
        capture.begin_stretch()
        time.sleep(max(0.0, stretch[1] - time.perf_counter()))
        capture.stop()
    for t in threads:
        t.join()
    end = max([deadline] + [r.end for r in records])
    return records, begin, end


def judge(records: List[Record], oracles, paths, limits: dict) -> dict:
    """Every result of the window against the reference. Returns the
    numbers compared, each with its limit."""
    from benchmark.reference.compare import compare, normalize

    tables = lake_tables(paths)
    wanted = {}
    for q in sorted({r.query for r in records if r.error is None}):
        want = oracles[q](tables)
        wanted[q] = (want, normalize(want))
    wrong, gap, first = 0, 0.0, ""
    for r in records:
        if r.error is not None:
            continue
        v = compare(r.table.to_pandas(), *wanted[r.query])
        if not v.exact:
            wrong += 1
            first = first or f"{r.query}: {v.reason}"
        gap = max(gap, v.gap)
    failed = sum(r.error is not None for r in records)
    return {"compared": {
        "failed_queries": {"value": failed, "limit": 0},
        "wrong_results": {"value": wrong, "limit": 0},
        "max_rel_gap": {"value": gap, "limit": limits["max_rel_gap"]}},
        "first_wrong": first,
        "results_compared": len(records) - failed}


def build_indexes(hs, dfs, fam, config, spans: Spans,
                  capture: Optional[Capture]) -> Tuple[float, list]:
    """Every index of the configuration, each ending with its files
    written. Returns the seconds they took together and their spans."""
    from hyperspace_tpu_torch import IndexConfig

    own = Spans()
    total = 0.0
    if capture is not None:
        capture.start()
    for name in config["indexes"]:
        table, (indexed, included) = fam.index_defs[name]
        t0 = time.perf_counter()
        with own(f"create_index:{name}"):
            hs.create_index(dfs[table], IndexConfig(name, indexed, included))
        total += time.perf_counter() - t0
    if capture is not None:
        capture.stop()
        capture.export()
    spans.items.extend(own.items)
    return total, own.items


def run_cell(root: str, cell: spec.Cell, seed: int, seconds: float,
             trace: bool, process_start: float, device=None) -> dict:
    """Set-up, window and comparison of one run. `device` is the card
    unless a test passes the CPU."""
    import torch

    from hyperspace_tpu_torch import Hyperspace, HyperspaceConf, HyperspaceSession

    config, traffic = cell.config, cell.traffic
    device = torch.device(device or "cuda")
    work = os.path.join(root, "benchmark", "_work", cell.name)
    out_dir = os.path.join(root, "benchmark", "_out")
    shutil.rmtree(work, ignore_errors=True)
    spans = Spans()
    try:
        fam = spec.load_family(config)
        with spans("setup:lake"):
            paths = fam.generate(os.path.join(work, "lake"),
                                 scale=config["generator_scale"],
                                 seed=data_seed(seed))
        with spans("setup:kernels"):
            load_kernels(device)
        settings = {"spark.hyperspace.warehouse.dir": os.path.join(work, "wh"),
                    **config["conf"]}
        session = HyperspaceSession(HyperspaceConf(settings),
                                    device=str(device))
        hs = Hyperspace(session)
        dfs = {t: session.read_parquet(p) for t, p in paths.items()}
        build_capture = (Capture(os.path.join(work, "build_trace.json"))
                         if trace else None)
        build_s, build_spans = build_indexes(hs, dfs, fam, config, spans,
                                             build_capture)
        session.enable_hyperspace()
        for _ in range(int(traffic["warmup_passes"])):
            for q in traffic["queries"]:
                with spans(f"warm-up:{q}"):
                    fam.builders[q](dfs).collect()
        if device.type == "cuda":
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - process_start
        builds = {k: v for k, v in registry_state()["counters"].items()
                  if k.startswith("compile.")}

        window_capture = (Capture(os.path.join(work, "window_trace.json"))
                          if trace else None)
        before = registry_state()
        host = HostWatch()
        records, begin, end = drive(fam.builders, dfs,
                                    streams.stream_orders(traffic, seed),
                                    seconds, spans, window_capture)
        host = host.stop()
        after = registry_state()
        window_s = end - begin
        peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)
        kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
                else "cpu")
        if window_capture is not None:
            window_capture.export()

        session.close()
        del dfs, hs, session
        from hyperspace_tpu_torch.io import parquet, segcache
        segcache.clear()
        parquet.clear_read_cache()
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()

        t0 = time.perf_counter()
        verdict = judge(records, fam.oracles, paths, config["limits"])
        reference_s = time.perf_counter() - t0

        done = [r for r in records if r.error is None]
        latencies = [(r.end - r.start) * 1e3 for r in done]
        result = {
            "correct": bool(done) and all(
                c["value"] <= c["limit"]
                for c in verdict["compared"].values()),
            "attempted": len(records),
            "failed": len(records) - len(done),
            "metrics": {},
            "device": {"platform": "gpu" if device.type == "cuda" else "cpu",
                       "kind": kind,
                       "count": cell.chips,
                       "memory_peak_bytes": int(peak)},
        }
        units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
        if not trace:
            values = {"qps": stats.rate(len(done), window_s),
                      "p95_ms": stats.percentile(latencies, 95) if latencies else 0.0,
                      "setup_s": setup_s}
            for m in cell.end_to_end:
                result["metrics"][m["name"]] = {"value": values[m["name"]],
                                                "unit": m["unit"]}
        else:
            wtrace = (window_capture.trace(spans.items)
                      if window_capture is not None else None)
            btrace = (build_capture.trace(build_spans)
                      if build_capture is not None else None)
            counters, histograms = deltas(before, after)
            readings = Readings(
                completed=len(done), window_s=window_s,
                counters=counters, histograms=histograms,
                window_trace=wtrace, build_trace=btrace, build_s=build_s,
                index_keys=index_keys(paths, fam.index_defs,
                                      config["indexes"]),
                device_kind=kind)
            for m in cell.per_layer:
                value = spec.metric_reader(root, m["name"])(readings)
                if value is not None:
                    result["metrics"][m["name"]] = {"value": value,
                                                    "unit": units[m["name"]]}
            if wtrace is not None:
                result["device"]["busy_s"] = wtrace.busy_s
                result["device"]["window_s"] = wtrace.window_s
                result["breakdown"] = {"device_ops": wtrace.top_ops(10),
                                       "idle_gaps": wtrace.idle_gaps(10)}
            os.makedirs(out_dir, exist_ok=True)
            with open(os.path.join(out_dir, f"{cell.name}.{seed}.spans.jsonl"),
                      "w") as f:
                for name, s, e in sorted(spans.items, key=lambda x: x[1]):
                    f.write(json.dumps({"name": name, "start_ns": s,
                                        "end_ns": e}) + "\n")
        result["notes"] = {
            "window_s": window_s, "setup_s": setup_s, "build_s": build_s,
            "reference_s": reference_s, "compile": builds,
            "setup_phases": phases(spans.items), "window_host": host,
            "results_compared": verdict["results_compared"],
            "first_wrong": verdict["first_wrong"],
            "per_query_ms": per_query(done)}
        result["compared"] = verdict["compared"]
        first_error = next((r.error for r in records if r.error), None)
        if first_error:
            print(first_error, file=sys.stderr)
        return result
    finally:
        shutil.rmtree(work, ignore_errors=True)


def phases(items) -> Dict[str, float]:
    """Seconds of each set-up step, from the benchmark's spans."""
    out: Dict[str, float] = {}
    for name, s, e in items:
        step = name if name.startswith("setup:") else name.split(":", 1)[0]
        if step != "collect":
            out[step] = out.get(step, 0.0) + (e - s) / 1e9
    return out


class HostWatch:
    """What the host did for this process over the window: its CPU
    seconds and its garbage collections."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.times = os.times()
        self.gc_s = 0.0
        self.gc_n = 0
        self._gc_t = 0.0
        gc.callbacks.append(self._gc)

    def _gc(self, phase, _info):
        if phase == "start":
            self._gc_t = time.perf_counter()
        else:
            self.gc_s += time.perf_counter() - self._gc_t
            self.gc_n += 1

    def stop(self) -> dict:
        gc.callbacks.remove(self._gc)
        wall = time.perf_counter() - self.t0
        t = os.times()
        out = {"wall_s": wall,
               "process_cpu_s": (t.user - self.times.user)
               + (t.system - self.times.system),
               "gc_collections": self.gc_n, "gc_s": self.gc_s}
        return out


def per_query(done: List[Record]) -> Dict[str, list]:
    """Count, median and largest latency (ms) of each query."""
    by: Dict[str, List[float]] = {}
    for r in done:
        by.setdefault(r.query, []).append((r.end - r.start) * 1e3)
    return {q: [len(v), stats.percentile(v, 50), max(v)]
            for q, v in sorted(by.items())}


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, root: str, process_start: float) -> int:
    args = parse(argv)
    cell = spec.find_cell(root, args.workload)
    import torch

    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell.chips:
        print(f"benchmark: {cell.name} needs {cell.chips} CUDA device(s), "
              f"found {found}; no result", file=sys.stderr)
        return 2
    result = run_cell(root, cell, args.seed, args.seconds, bool(args.trace),
                      process_start)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the run imported {bad}; no result",
              file=sys.stderr)
        return 3
    result["notes"]["card"] = card()
    print("benchmark: notes " + json.dumps(result["notes"]), file=sys.stderr)
    for name, c in result["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
