"""The port's pipelined transfer engine (`hyperspace_tpu_torch/io/
transfer.py`) on the CPU, against the JAX package's.

Replays `tests/test_transfer.py` on the port — every scenario but the two
that need the fault injector, which the port has not yet — with the same
seeded inputs through both packages where a scenario produces data: the
chunked column decode equals the plain one and the JAX package's, the
in-flight byte window holds, staging buffers are reused on a copying
link and never on the CPU (which aliases), decode overlaps a slow link,
and a build's bucket files are the same bytes however the permutation is
chunked or the payload decoded.
"""

import os
import threading
import time

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
from torch_suites import jax_counters_guard  # noqa: E402,F401
import torch

from hyperspace_tpu.io import builder as jbuilder
from hyperspace_tpu.io import columnar as jcolumnar
from hyperspace_tpu_torch import telemetry
from hyperspace_tpu_torch.io import builder, columnar, transfer
from hyperspace_tpu_torch.io.transfer import Host, HostCast, TransferEngine

CPU = torch.device("cpu")


@pytest.fixture
def engine():
    """Install a purpose-built engine as THE process engine; restore the
    default on teardown (the engine is process-wide state)."""
    def make(**kwargs) -> TransferEngine:
        return transfer.set_engine(TransferEngine(**kwargs))

    yield make
    transfer.reset_engine()


def _counter(name):
    return telemetry.get_registry().counter(name).value


def sample_table(n: int = 5000) -> pa.Table:
    rng = np.random.default_rng(7)
    ints = rng.integers(0, 1 << 40, n).astype(np.int64)
    return pa.table({
        "i64": ints,
        "i32": pa.array(
            np.where(np.arange(n) % 7 == 0, None,
                     rng.integers(-1000, 1000, n)).tolist(),
            type=pa.int32()),
        "f64": pa.array(
            np.where(np.arange(n) % 5 == 0, None, rng.random(n)).tolist(),
            type=pa.float64()),
        "s": pa.array([None if i % 11 == 0 else f"v{i % 97}"
                       for i in range(n)], type=pa.string()),
        "b": rng.integers(0, 2, n).astype(bool),
    })


def batch_host_view(batch):
    """{name: (data, validity)} as numpy, for value comparison."""
    def host(a):
        return None if a is None else (
            a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a))
    return {name: (host(col.data), host(col.validity))
            for name, col in batch.columns.items()}


class FakeDev:
    """A fake device array for fake-link engines: remembers its payload,
    completes after `latency_s` (block_until_ready waits it out)."""

    def __init__(self, arr, latency_s: float = 0.0):
        self.np = np.asarray(arr).copy()  # copy, like a real transfer
        self.nbytes = self.np.nbytes
        self.done_at = time.perf_counter() + latency_s
        self.blocked = False

    def block_until_ready(self):
        delay = self.done_at - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        self.blocked = True
        return self

    def __array__(self, dtype=None, copy=None):
        return self.np if dtype is None else self.np.astype(dtype)


# ---------------------------------------------------------------------------
# Chunked round-trip equivalence
# ---------------------------------------------------------------------------


def test_chunked_from_arrow_matches_plain(engine):
    table = sample_table()
    plain = columnar.from_arrow(table, device=CPU)  # default engine
    engine(chunk_bytes=1024, inflight_bytes=8192, threads=2)
    chunked = columnar.from_arrow(table, device=CPU)
    assert transfer.get_engine().stats["chunks"] > len(table.column_names)
    reference = jcolumnar.from_arrow(table, device=False)

    a, b = batch_host_view(plain), batch_host_view(chunked)
    for name in a:
        ref = reference.columns[name]
        np.testing.assert_array_equal(a[name][0], b[name][0])
        np.testing.assert_array_equal(b[name][0], np.asarray(ref.data))
        da, db = plain.columns[name], chunked.columns[name]
        assert da.data.dtype == db.data.dtype
        if a[name][1] is None:
            assert b[name][1] is None and ref.validity is None
        else:
            np.testing.assert_array_equal(a[name][1], b[name][1])
            np.testing.assert_array_equal(b[name][1],
                                          np.asarray(ref.validity))
        if da.is_string:
            np.testing.assert_array_equal(da.dictionary, db.dictionary)
            np.testing.assert_array_equal(db.dictionary, ref.dictionary)
            for got, want in zip(db.dict_hashes, ref.dict_hashes):
                np.testing.assert_array_equal(got.numpy(),
                                              np.asarray(want))
    # Arrow round trip preserves values + null masks exactly.
    assert columnar.to_arrow(chunked).equals(columnar.to_arrow(plain))
    assert columnar.to_arrow(chunked).equals(table)


def test_chunked_roundtrip_empty_and_tiny(engine):
    engine(chunk_bytes=64, inflight_bytes=256, threads=1)
    empty = sample_table(0)
    assert columnar.to_arrow(columnar.from_arrow(empty, device=CPU)) \
        .equals(empty)
    tiny = sample_table(3)
    assert columnar.to_arrow(columnar.from_arrow(tiny, device=CPU)) \
        .equals(tiny)


def test_put_chunks_concatenate_to_source(engine):
    engine(chunk_bytes=4096, inflight_bytes=1 << 20, threads=2)
    arr = np.arange(10_000, dtype=np.int64)
    parts = transfer.get_engine().put_chunks(HostCast(arr, np.int32), CPU)
    assert len(parts) > 1
    got = np.concatenate([p.numpy() for p in parts])
    np.testing.assert_array_equal(got, arr.astype(np.int32))


# ---------------------------------------------------------------------------
# In-flight byte window
# ---------------------------------------------------------------------------


def test_inflight_byte_window_enforced(engine):
    outstanding = []
    lock = threading.Lock()
    max_seen = [0]

    def slow_put(arr, device):
        dev = FakeDev(arr, latency_s=0.002)
        with lock:
            outstanding.append(dev)
            live = sum(d.nbytes for d in outstanding if not d.blocked)
            max_seen[0] = max(max_seen[0], live)
        return dev

    window = 4096
    eng = engine(chunk_bytes=1024, inflight_bytes=window, threads=2,
                 put_fn=slow_put)
    arr = np.arange(8192, dtype=np.int8)  # 8 chunks of 1 KiB
    parts = eng.put_chunks(arr)
    assert len(parts) == 8
    assert max_seen[0] <= window
    assert eng.stats["window_waits"] > 0
    got = np.concatenate([p.np for p in parts])
    np.testing.assert_array_equal(got, arr)


# ---------------------------------------------------------------------------
# Staging-buffer reuse
# ---------------------------------------------------------------------------


def test_staging_buffers_reused_not_rematerialized(engine, monkeypatch):
    # Drop the staging floor so test-size chunks hit the buffer pool. The
    # fake link COPIES (like the card's H2D from pinned memory); on the
    # CPU staging is disabled — see the test below.
    monkeypatch.setattr(transfer, "_STAGING_MIN_BYTES", 1)
    eng = engine(chunk_bytes=4096, inflight_bytes=8192, threads=2,
                 put_fn=lambda arr, device: FakeDev(arr))
    arr = np.arange(64_000, dtype=np.int64)  # ~63 int32 chunks
    parts = eng.put_chunks(HostCast(arr, np.int32))
    got = np.concatenate([p.np for p in parts])
    np.testing.assert_array_equal(got, arr.astype(np.int32))
    stats = eng.stats
    assert stats["staging_reused"] > 20, stats
    # Double-buffering needs only a handful of buffers, not one per chunk.
    assert stats["staging_allocated"] <= 2 * eng.threads + 2, stats
    assert stats["staging_allocated"] + stats["staging_reused"] \
        == len(parts)


def test_staging_disabled_on_cpu_aliasing_backend(engine):
    # A CPU "device" tensor may BE the host array (`torch.from_numpy`);
    # rewriting a reused staging buffer would then corrupt already-placed
    # chunks, so the engine must refuse staging on the CPU — and values
    # must stay correct without it.
    eng = engine(chunk_bytes=4096, inflight_bytes=1 << 20, threads=2)
    assert eng._staging_ok(CPU) is False
    arr = np.arange(100_000, dtype=np.int64)
    parts = eng.put_chunks(HostCast(arr, np.int32), CPU)
    got = np.concatenate([p.numpy() for p in parts])
    np.testing.assert_array_equal(got, arr.astype(np.int32))
    assert eng.stats["staging_reused"] == 0
    assert eng.stats["staging_allocated"] == 0


# ---------------------------------------------------------------------------
# Overlap: decode + link pipelining beats the serial sum
# ---------------------------------------------------------------------------


def test_slow_link_overlap_beats_serial(engine):
    put_s = 0.01
    decode_s = 0.02
    n_jobs = 6

    def slow_put(arr, device):
        time.sleep(put_s)  # a dispatch-blocking link
        return FakeDev(arr)

    eng = engine(chunk_bytes=1 << 20, inflight_bytes=1 << 22, threads=2,
                 put_fn=slow_put)

    def job():
        time.sleep(decode_s)  # Arrow decode stage
        return {"data": np.arange(256, dtype=np.int64)}

    saved_before = _counter("transfer.overlap_saved_seconds")
    t0 = time.perf_counter()
    results = eng.put_group([job] * n_jobs)
    wall = time.perf_counter() - t0
    serial = n_jobs * (decode_s + put_s)
    assert wall < 0.8 * serial, (wall, serial)
    assert len(results) == n_jobs
    for r in results:
        np.testing.assert_array_equal(r["data"].np,
                                      np.arange(256, dtype=np.int64))
    assert _counter("transfer.overlap_saved_seconds") > saved_before


def test_put_group_host_marker_passthrough(engine):
    eng = engine()
    dictionary = np.array(["a", "b"])
    [res] = eng.put_group([lambda: {"data": np.arange(4),
                                    "dictionary": Host(dictionary),
                                    "n": 4, "none": None}], device=CPU)
    assert res["dictionary"] is dictionary
    assert res["n"] == 4 and res["none"] is None
    assert isinstance(res["data"], torch.Tensor)  # placed on the device
    np.testing.assert_array_equal(res["data"].numpy(), np.arange(4))


# ---------------------------------------------------------------------------
# Telemetry & counters
# ---------------------------------------------------------------------------


def test_link_chunk_counters_and_d2h(engine):
    h2d_chunks0 = _counter("link.h2d.chunks")
    d2h_chunks0 = _counter("link.d2h.chunks")
    eng = engine(chunk_bytes=1024, inflight_bytes=8192, threads=2)
    dev = eng.put(np.arange(1024, dtype=np.int64), CPU)  # 8 chunks
    assert _counter("link.h2d.chunks") >= h2d_chunks0 + 8
    np.testing.assert_array_equal(eng.fetch(dev),
                                  np.arange(1024, dtype=np.int64))
    assert _counter("link.d2h.chunks") > d2h_chunks0


def test_prefetch_errors_are_counted(engine, monkeypatch):
    eng = engine()

    def dead_dma(arr):
        if not isinstance(arr, np.ndarray):
            raise RuntimeError("dead DMA path")

    monkeypatch.setattr(eng, "_prefetch_one", dead_dma)
    before = _counter("link.d2h.prefetch_errors")
    eng.prefetch(torch.zeros(3), np.arange(3), torch.ones(2))
    assert _counter("link.d2h.prefetch_errors") == before + 2


def test_conf_knobs_configure_engine(engine):
    from hyperspace_tpu_torch.config import HyperspaceConf

    eng = engine()
    conf = HyperspaceConf({
        "spark.hyperspace.io.transfer.chunk.bytes": "2048",
        "spark.hyperspace.io.transfer.inflight.bytes": "16384",
        "spark.hyperspace.io.transfer.threads": "3",
    })
    transfer.configure(conf)
    assert eng.chunk_bytes == 2048
    assert eng.inflight_bytes == 16384
    assert eng.threads == 3


# ---------------------------------------------------------------------------
# Build-path identity: chunked pipeline == serial path, byte for byte
# ---------------------------------------------------------------------------


def build_table(n: int = 20_000) -> pa.Table:
    rng = np.random.default_rng(11)
    return pa.table({
        "key": rng.integers(0, n // 4, n).astype(np.int64),
        "score": rng.random(n).astype(np.float64),
    })


def read_sorted_runs(path):
    from hyperspace_tpu_torch.io import parquet as pq_io
    per_bucket = pq_io.bucket_files(str(path))
    return {b: pq_io.read_table(files)
            for b, files in sorted(per_bucket.items())}


def _file_bytes(path):
    out = {}
    for name in sorted(os.listdir(path)):
        if name.endswith(".parquet"):
            with open(os.path.join(path, name), "rb") as f:
                out[name] = f.read()
    return out


def _device_lane(monkeypatch):
    """Force the port's DEVICE permutation lane on the CPU (whatever the
    build size and the native library)."""
    monkeypatch.setattr(builder, "BUILD_MIN_DEVICE_ROWS", 0)
    monkeypatch.setattr(builder, "_host_lane_preferred",
                        lambda rows, device=None: False)


def test_sorted_runs_identical_across_chunking(engine, tmp_path,
                                               monkeypatch):
    table = build_table()
    _device_lane(monkeypatch)
    engine(chunk_bytes=1 << 26, inflight_bytes=1 << 28)  # effectively serial
    serial = builder.write_bucketed_table(table, ["key"], 8,
                                          str(tmp_path / "serial"),
                                          device=CPU)
    engine(chunk_bytes=16 * 1024, inflight_bytes=64 * 1024, threads=2)
    assert transfer.get_engine().d2h_chunk_count(table.num_rows * 8) > 1
    chunked = builder.write_bucketed_table(table, ["key"], 8,
                                           str(tmp_path / "chunked"),
                                           device=CPU)
    assert serial and chunked
    # The port never splits a bucket: the chunked D2H is cut at bucket
    # boundaries, so the files are the same names and the same bytes.
    assert _file_bytes(tmp_path / "serial") == \
        _file_bytes(tmp_path / "chunked")
    jbuilder.write_bucketed_table(table, ["key"], 8, str(tmp_path / "jax"))
    a = read_sorted_runs(tmp_path / "chunked")
    b = read_sorted_runs(tmp_path / "jax")
    assert set(a) == set(b)
    for bucket in a:
        assert a[bucket].equals(b[bucket]), f"bucket {bucket} diverged"


def test_pipelined_file_build_matches_host_lane(engine, tmp_path,
                                                monkeypatch):
    table = build_table(8000)
    src = tmp_path / "src"
    src.mkdir()
    pq.write_table(table.slice(0, 3000), str(src / "part-0.parquet"))
    pq.write_table(table.slice(3000), str(src / "part-1.parquet"))
    files = [str(src / "part-0.parquet"), str(src / "part-1.parquet")]

    engine(chunk_bytes=8 * 1024, inflight_bytes=32 * 1024, threads=2)
    host = builder.write_bucketed_from_files(
        files, ["key", "score"], ["key"], 8, str(tmp_path / "host"), CPU)
    _device_lane(monkeypatch)
    dev = builder.write_bucketed_from_files(
        files, ["key", "score"], ["key"], 8, str(tmp_path / "dev"), CPU)
    assert host and dev
    assert _file_bytes(tmp_path / "host") == _file_bytes(tmp_path / "dev")
    jbuilder.write_bucketed_from_files(files, ["key", "score"], ["key"], 8,
                                       str(tmp_path / "jax"))
    a = read_sorted_runs(tmp_path / "dev")
    b = read_sorted_runs(tmp_path / "jax")
    assert set(a) == set(b)
    for bucket in a:
        assert a[bucket].equals(b[bucket])
