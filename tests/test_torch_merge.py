"""The port's merge-compaction permutations against the JAX package's, on
the CPU.

The same bucket-ordered key batches, made from a seed with numpy, go
through `hyperspace_tpu.ops.merge` and `hyperspace_tpu_torch.ops.merge`:

- the torch `bucket_sort_permutation` (one stable (bucket, *key lanes)
  sort on torch tensors) must equal the JAX program's permutation element
  for element, with equal `starts`/`ends`, over ragged bucket lengths,
  empty buckets, multi-lane, float, nullable and string keys;
- `host_bucket_sort_permutation` and `host_merge_runs_permutation` must
  equal the JAX package's host twins;
- `compact_index` on each of its three lanes (merge, host lexsort, device)
  must write the files a full rebuild writes, byte for byte.

Integers compare exactly; there is no tolerance anywhere here.
"""

import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
from torch_suites import jax_counters_guard  # noqa: E402,F401
import torch

from hyperspace_tpu.io import columnar as jcol
from hyperspace_tpu.ops import merge as jmerge

# The suite runs in parallel worker processes; one torch thread per worker
# keeps torch's spinning OpenMP pool from starving the other workers.
torch.set_num_threads(1)

from hyperspace_tpu_torch.io import builder as tbuilder
from hyperspace_tpu_torch.io import columnar as tcol
from hyperspace_tpu_torch.ops import merge as tmerge

CPU = torch.device("cpu")


def _lengths(kind, num_buckets, rng):
    """Per-bucket row counts: ragged, with empty buckets (every third
    bucket and the last one); one big bucket; or three small buckets in
    a sea of empty ones."""
    lengths = rng.integers(1, 90, num_buckets).astype(np.int64)
    if kind == "sparse":
        lengths[:] = 0
        lengths[[1, 17, num_buckets - 2]] = (3, 1, 40)
    lengths[::3] = 0
    lengths[-1] = 0
    if kind == "one_big":
        lengths[:] = 0
        lengths[num_buckets // 2] = 4000
    return lengths


def _keys(kind, n, rng):
    """(arrow table of key columns, sort columns)."""
    if kind == "int64":
        return pa.table({"k": rng.integers(0, 30, n).astype(np.int64)}), ["k"]
    if kind == "signed_multi":
        return pa.table({
            "a": rng.integers(-2**62, 2**62, n).astype(np.int64),
            "b": rng.integers(-5, 5, n).astype(np.int32)}), ["b", "a"]
    if kind == "float64":
        pool = np.array([0.0, -0.0, np.nan, np.inf, -np.inf, 1.0, -1.0, 2.5])
        return pa.table({"f": pool[rng.integers(0, len(pool), n)]}), ["f"]
    if kind == "nullable":
        return pa.table({"k": pa.array(
            rng.integers(0, 12, n).astype(np.int64),
            mask=rng.random(n) < 0.2)}), ["k"]
    if kind == "string":
        return pa.table({"s": pa.array(
            [None if x == 0 else f"w{int(x)}"
             for x in rng.integers(0, 25, n)])}), ["s"]
    raise ValueError(kind)


KEY_KINDS = ("int64", "signed_multi", "float64", "nullable", "string")


@pytest.mark.parametrize("lengths_kind", ["ragged", "one_big", "sparse"])
@pytest.mark.parametrize("key_kind", KEY_KINDS)
def test_bucket_sort_permutation_equals_jax(key_kind, lengths_kind):
    rng = np.random.default_rng(KEY_KINDS.index(key_kind) * 10 + 3)
    lengths = _lengths(lengths_kind, 37, rng)
    table, names = _keys(key_kind, int(lengths.sum()), rng)
    jchunks, jstarts, jends = jmerge.bucket_sort_permutation(
        jcol.from_arrow(table), names, lengths)
    (tperm,), tstarts, tends = tmerge.bucket_sort_permutation(
        tcol.from_arrow(table, device=CPU), names, lengths)
    jperm = np.concatenate([np.asarray(c) for c in jchunks])
    assert tperm.dtype == torch.int64
    assert np.array_equal(tperm.numpy(), jperm)
    assert np.array_equal(tstarts, np.asarray(jstarts))
    assert np.array_equal(tends, np.asarray(jends))


@pytest.mark.parametrize("key_kind", KEY_KINDS)
def test_host_bucket_sort_permutation_equals_jax(key_kind):
    rng = np.random.default_rng(KEY_KINDS.index(key_kind) + 50)
    lengths = _lengths("ragged", 23, rng)
    table, names = _keys(key_kind, int(lengths.sum()), rng)
    (jperm,), jstarts, jends = jmerge.host_bucket_sort_permutation(
        jcol.from_arrow(table, device=False), names, lengths)
    (tperm,), tstarts, tends = tmerge.host_bucket_sort_permutation(
        tcol.from_arrow(table), names, lengths)
    assert np.array_equal(tperm, np.asarray(jperm))
    assert np.array_equal(tstarts, jstarts) and np.array_equal(tends, jends)
    # The device lane computes the same permutation as the host lane.
    (dperm,), _, _ = tmerge.bucket_sort_permutation(
        tcol.from_arrow(table, device=CPU), names, lengths)
    assert np.array_equal(dperm.numpy(), tperm)


def test_bucket_sort_permutation_of_no_rows():
    """All buckets empty: an empty permutation and zero bounds (the JAX
    program needs at least one row, so this case is the port's alone)."""
    lengths = np.zeros(9, dtype=np.int64)
    table = pa.table({"k": np.zeros(0, dtype=np.int64)})
    (perm,), starts, ends = tmerge.bucket_sort_permutation(
        tcol.from_arrow(table, device=CPU), ["k"], lengths)
    assert perm.numel() == 0
    assert not starts.any() and not ends.any()


@pytest.mark.parametrize("unsorted_base", [False, True])
def test_host_merge_runs_permutation_equals_jax(unsorted_base):
    """Per bucket: one sorted base run and three small delta runs (or an
    unsorted base, which takes the bucket-local sort fallback)."""
    rng = np.random.default_rng(9 + unsorted_base)
    keys, run_bounds, offset = [], [], 0
    for b in range(19):
        runs = []
        # Every seventh bucket is absent (no runs); every fifth has an
        # empty base run.
        sizes = () if b % 7 == 0 else (0 if b % 5 == 0 else 60, 7, 0, 12)
        for r, n in enumerate(sizes):
            part = rng.integers(0, 25, n)
            if r == 0 and not unsorted_base:
                part = np.sort(part)
            keys.append(part)
            runs.append((offset, offset + n))
            offset += n
        run_bounds.append(runs)
    key = np.concatenate(keys).astype(np.int64)
    (jperm,), jstarts, jends = jmerge.host_merge_runs_permutation(
        key, run_bounds)
    (tperm,), tstarts, tends = tmerge.host_merge_runs_permutation(
        key, run_bounds)
    assert np.array_equal(tperm, jperm)
    assert np.array_equal(tstarts, jstarts) and np.array_equal(tends, jends)
    # Each bucket comes out sorted by key.
    for s, e in zip(tstarts, tends):
        assert (np.diff(key[tperm[s:e]]) >= 0).all()


# -- compact_index on each lane: byte-equal to a full rebuild ----------------


def _rows(start, n, seed, key_kind):
    r = np.random.default_rng(seed)
    cols = {"k": r.integers(0, 30, n).astype(np.int64),
            "v": r.random(n),
            "id": np.arange(start, start + n, dtype=np.int64)}
    if key_kind == "composite":
        cols["s"] = pa.array([f"s{int(x)}" for x in r.integers(0, 9, n)])
    return pa.table(cols)


class _Entry:
    """The fields of an index log entry `compact_index` reads."""

    def __init__(self, root, indexed, num_buckets):
        self.content = type("C", (), {"root": root})()
        self.indexed_columns = indexed
        self.num_buckets = num_buckets


@pytest.mark.parametrize("lane", ["merge", "host-lexsort", "device"])
def test_compact_index_lanes_match_a_full_rebuild(tmp_path, monkeypatch,
                                                  lane):
    key_kind = "single" if lane == "merge" else "composite"
    indexed = ["k"] if key_kind == "single" else ["k", "s"]
    if lane != "merge":
        monkeypatch.setattr(tbuilder, "_merge_path_permutation",
                            lambda *a, **k: None)
    if lane == "device":
        # On a CPU session the torch lane runs when the native library is
        # absent (with it, the session takes the native radix sort).
        from hyperspace_tpu_torch import native as tnative
        monkeypatch.setattr(tnative, "get_lib", lambda: None)
        monkeypatch.setattr(tbuilder, "BUILD_MIN_DEVICE_ROWS", 0)
    parts = [_rows(0, 700, 1, key_kind)] + [
        _rows(1000 * (i + 1), 90, 10 + i, key_kind) for i in range(3)]
    runs = str(tmp_path / "runs")
    # A base build, then one delta run per appended slice.
    tbuilder.write_bucketed_table(parts[0], indexed, 16, runs, device=CPU)
    for i, part in enumerate(parts[1:], start=1):
        tbuilder.write_bucketed_table(part, indexed, 16, runs,
                                      file_suffix=f"delta{i}", device=CPU)
    out = str(tmp_path / "compacted")
    written, took = tbuilder.compact_index(_Entry(runs, indexed, 16), out,
                                           CPU)
    assert took == lane and written
    rebuild = str(tmp_path / "rebuild")
    tbuilder.write_bucketed_table(pa.concat_tables(parts), indexed, 16,
                                  rebuild, device=CPU)
    names = sorted(f for f in os.listdir(rebuild) if f.endswith(".parquet"))
    assert sorted(os.path.basename(f) for f in written) == names
    for name in names:
        with open(os.path.join(out, name), "rb") as a, \
                open(os.path.join(rebuild, name), "rb") as b:
            assert a.read() == b.read(), name
    assert pq.read_table(out).num_rows == sum(p.num_rows for p in parts)
