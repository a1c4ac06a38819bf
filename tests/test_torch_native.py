"""The port's native host library (`hyperspace_tpu_torch/native`) against
numpy and against the JAX package's library.

`g++` is present here, so the library builds for real at first use into
`hyperspace_tpu_torch/_build/`. Replays the eight tests of
`tests/test_native.py` on the port's copy, then holds the two packages
to each other on the same seeded inputs: the FNV-1a string hashes bit
for bit (empty, non-ASCII, long and dictionary-typed strings with
nulls), the radix-sort permutations and the merge-join pairs element for
element, and the index files written by the port with the library and
without it, and by the JAX package with its library, byte for byte.
"""

import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
from torch_suites import jax_counters_guard  # noqa: E402,F401
import torch

from hyperspace_tpu import native as jnative
from hyperspace_tpu.io import builder as jbuilder
from hyperspace_tpu.io import columnar as jcolumnar
from hyperspace_tpu.ops import join as jjoin
from hyperspace_tpu_torch import native, telemetry
from hyperspace_tpu_torch.io import builder, columnar
from hyperspace_tpu_torch.ops import join as tjoin

CPU = torch.device("cpu")


@pytest.fixture
def lib():
    """The port's library; its build must succeed where `g++` is."""
    loaded = native.get_lib()
    assert loaded is not None, "the native host library did not build"
    return loaded


@pytest.fixture
def jax_lib():
    if jnative.get_lib() is None:
        pytest.skip("the JAX package's native library is unavailable")


def _no_native(monkeypatch):
    monkeypatch.setattr(native, "get_lib", lambda: None)


def _ref_perm(bucket, lanes):
    return np.lexsort(tuple(reversed([bucket] + list(lanes))))


def _ref_bounds(bucket, perm, num_buckets):
    sb = bucket[perm]
    return (np.searchsorted(sb, np.arange(num_buckets), "left"),
            np.searchsorted(sb, np.arange(num_buckets), "right"))


def _check(bucket, num_buckets, lanes):
    out = native.bucket_key_sort_perm(bucket, num_buckets, lanes)
    assert out is not None
    perm, starts, ends = out
    ref = _ref_perm(bucket, lanes)
    np.testing.assert_array_equal(perm, ref)
    rs, re = _ref_bounds(bucket, ref, num_buckets)
    np.testing.assert_array_equal(starts, rs)
    np.testing.assert_array_equal(ends, re)


# ---------------------------------------------------------------------------
# The eight scenarios of tests/test_native.py, on the port's library
# ---------------------------------------------------------------------------


def test_single_int64_key_lanes(lib):
    rng = np.random.default_rng(7)
    n = 100_000
    key = rng.integers(-(1 << 62), 1 << 62, n, dtype=np.int64)
    bucket = rng.integers(0, 32, n).astype(np.int32)
    lanes = [(key >> 32).astype(np.int32),
             (key & 0xFFFFFFFF).astype(np.uint32)]
    _check(bucket, 32, lanes)


def test_small_range_keys_skip_passes(lib):
    rng = np.random.default_rng(8)
    n = 50_000
    key = rng.integers(0, 1000, n, dtype=np.int64)  # constant hi digits
    bucket = rng.integers(0, 8, n).astype(np.int32)
    lanes = [(key >> 32).astype(np.int32),
             (key & 0xFFFFFFFF).astype(np.uint32)]
    _check(bucket, 8, lanes)


def test_stability_ties_keep_input_order(lib):
    n = 10_000
    bucket = np.zeros(n, dtype=np.int32)
    lane = np.full(n, 42, dtype=np.uint32)
    perm, starts, ends = native.bucket_key_sort_perm(bucket, 4, [lane])
    np.testing.assert_array_equal(perm, np.arange(n, dtype=np.int32))
    assert starts[0] == 0 and ends[0] == n and ends[3] == n


def test_odd_lane_count_with_validity(lib):
    rng = np.random.default_rng(9)
    n = 30_000
    bucket = rng.integers(0, 16, n).astype(np.int32)
    validity = rng.random(n) > 0.1  # bool lane leads (nulls first)
    lane = rng.integers(0, 1 << 31, n).astype(np.int32)
    _check(bucket, 16, [validity, lane])


def test_multi_key_four_lanes(lib):
    rng = np.random.default_rng(10)
    n = 40_000
    bucket = rng.integers(0, 64, n).astype(np.int32)
    k1 = rng.integers(-(1 << 40), 1 << 40, n, dtype=np.int64)
    k2 = rng.integers(-(1 << 40), 1 << 40, n, dtype=np.int64)
    lanes = [(k1 >> 32).astype(np.int32), (k1 & 0xFFFFFFFF).astype(np.uint32),
             (k2 >> 32).astype(np.int32), (k2 & 0xFFFFFFFF).astype(np.uint32)]
    _check(bucket, 64, lanes)


def test_empty_and_tiny(lib):
    _check(np.empty(0, dtype=np.int32), 4, [np.empty(0, dtype=np.uint32)])
    _check(np.zeros(1, dtype=np.int32), 1, [np.zeros(1, dtype=np.uint32)])


def test_signed_lane_ordering(lib):
    # Signed int32 lanes must order negatives before positives after the
    # uint32 bias — exactly lexsort's int32 order.
    bucket = np.zeros(6, dtype=np.int32)
    lane = np.array([5, -3, 0, -(1 << 31), (1 << 31) - 1, -1],
                    dtype=np.int32)
    _check(bucket, 1, [lane])


def test_builder_host_permutation_uses_native_layout(lib):
    """`_host_build_permutation` (native lane) produces the identical
    layout the lexsort reference produces."""
    from hyperspace_tpu_torch.ops.host_hash import (host_column_hash_lanes,
                                                    host_flat_hash32)
    from hyperspace_tpu_torch.ops.keys import host_column_sort_lanes

    rng = np.random.default_rng(11)
    n = 25_000
    table = pa.table({
        "key": rng.integers(0, n // 3, n).astype(np.int64),
        "val": rng.random(n),
    })
    perm, starts, ends = builder._host_build_permutation(table, ["key"], 16)
    assert perm.dtype == np.int32  # the native lane's permutation
    batch = columnar.from_arrow(table.select(["key"]))
    bucket = (host_flat_hash32(host_column_hash_lanes(batch.column("key")))
              % np.uint32(16)).astype(np.int32)
    ref = _ref_perm(bucket, host_column_sort_lanes(batch.column("key")))
    np.testing.assert_array_equal(perm, ref)


# ---------------------------------------------------------------------------
# The loader
# ---------------------------------------------------------------------------


def test_library_builds_into_the_port_build_dir(lib):
    path = native.library_path()
    assert os.path.dirname(path) == native.BUILD_DIR
    assert os.path.basename(os.path.dirname(os.path.dirname(path))) \
        == "hyperspace_tpu_torch"
    assert os.path.exists(path)
    # The source is the JAX package's, carried over as it is.
    jsrc = os.path.join(os.path.dirname(jnative.__file__),
                        "hyperspace_host.cpp")
    with open(native.SOURCE, "rb") as a, open(jsrc, "rb") as b:
        assert a.read() == b.read()


def test_fallback_counts_native_unavailable(monkeypatch):
    counter = telemetry.get_registry().counter("native.unavailable")
    before = counter.value
    _no_native(monkeypatch)
    assert native.string_hash64(np.array(["a"] * 100)) is None
    assert native.key_sort_perm(3, [np.arange(3, dtype=np.int32)]) is None
    assert counter.value == before + 2
    # ... and the callers still answer, on their numpy lanes.
    hashes = columnar._string_hash64(np.array(["a"] * 100))
    assert (hashes == columnar._string_hash64(np.array(["a"]))[0]).all()


# ---------------------------------------------------------------------------
# Parity with the JAX package
# ---------------------------------------------------------------------------

STRINGS = ["", "a", "héllo wörld", "日本語テキスト", "emoji 😀 ok",
           "x" * 10_000, "tab\tnew\nline", "\x00nul"] + \
    [f"value-{i:05d}" for i in range(200)]


def _python_hashes(values):
    out = np.empty(len(values), dtype=np.uint64)
    for i, v in enumerate(values):
        h = 0xCBF29CE484222325
        for b in str(v).encode("utf-8"):
            h = ((h ^ b) * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
        out[i] = h
    return out


def test_string_hashes_equal_bit_for_bit(lib, jax_lib, monkeypatch):
    values = np.asarray(STRINGS, dtype=object)
    want = _python_hashes(values)
    np.testing.assert_array_equal(native.string_hash64(values), want)
    np.testing.assert_array_equal(
        native.arrow_string_hash64(pa.array(STRINGS)), want)
    np.testing.assert_array_equal(
        native.arrow_string_hash64(pa.array(STRINGS, type=pa.large_string())),
        want)
    # A sliced array starts mid-buffer.
    np.testing.assert_array_equal(
        native.arrow_string_hash64(pa.array(STRINGS).slice(3, 50)),
        want[3:53])
    np.testing.assert_array_equal(columnar._string_hash64(values), want)
    np.testing.assert_array_equal(jcolumnar._string_hash64(values), want)
    np.testing.assert_array_equal(jnative.string_hash64(values), want)
    _no_native(monkeypatch)
    np.testing.assert_array_equal(columnar._string_hash64(values), want)


@pytest.mark.parametrize("kind", ["string", "dictionary", "large_string"])
def test_string_encode_equals_jax(lib, jax_lib, kind):
    rng = np.random.default_rng(5)
    pool = STRINGS[:8] + [f"w{i}" for i in range(300)]
    values = [None if i % 13 == 0 else pool[int(rng.integers(len(pool)))]
              for i in range(3000)]
    if kind == "dictionary":
        arr = pa.array(values).dictionary_encode()
    else:
        arr = pa.array(values, type=getattr(pa, kind)())
    got = columnar._encode_strings_arrow(arr)
    want = jcolumnar._encode_strings_arrow(arr)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[2], _python_hashes(got[1]))


@pytest.mark.parametrize("n_lanes", [1, 2, 3, 4])
def test_sort_permutations_equal_jax(lib, jax_lib, n_lanes):
    rng = np.random.default_rng(n_lanes)
    n = 60_000
    lanes = []
    for i in range(n_lanes):
        if i == 0 and n_lanes > 1:
            lanes.append(rng.random(n) > 0.2)  # a validity lane
        elif i % 2:
            lanes.append(rng.integers(-50, 50, n).astype(np.int32))
        else:
            lanes.append(rng.integers(0, 1 << 32, n).astype(np.uint32))
    bucket = rng.integers(0, 200, n).astype(np.int32)
    perm = native.key_sort_perm(n, lanes)
    np.testing.assert_array_equal(perm, jnative.key_sort_perm(n, lanes))
    np.testing.assert_array_equal(perm, _ref_perm(np.zeros(n, np.int32),
                                                  lanes))
    got = native.bucket_key_sort_perm(bucket, 200, lanes)
    want = jnative.bucket_key_sort_perm(bucket, 200, lanes)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _join_sides(seed):
    """Two index-layout sides: int64 keys sorted within 16 buckets."""
    rng = np.random.default_rng(seed)
    sides = []
    for n in (4000, 3000):
        lengths = rng.multinomial(n, np.ones(16) / 16)
        keys = np.concatenate([np.sort(rng.integers(0, 300, m))
                               for m in lengths]).astype(np.int64)
        table = pa.table({"k": keys, "v": rng.random(n)})
        sides.append((table, lengths))
    return sides


@pytest.mark.parametrize("how", ["inner", "left_outer"])
def test_merge_join_pairs_equal_jax(lib, jax_lib, how, monkeypatch):
    (lt, ll), (rt, rl) = _join_sides(3)
    left, right = columnar.from_arrow(lt), columnar.from_arrow(rt)
    jleft = jcolumnar.from_arrow(lt, device=False)
    jright = jcolumnar.from_arrow(rt, device=False)
    got = tjoin.host_bucketed_join_indices(left, right, ll, rl, ["k"],
                                           ["k"], how=how)
    want = jjoin.host_bucketed_join_indices(jleft, jright, ll, rl, ["k"],
                                            ["k"], how=how)
    assert len(got[0]) > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    # The numpy lane (library absent) gives the same pairs.
    _no_native(monkeypatch)
    plain = tjoin.host_bucketed_join_indices(left, right, ll, rl, ["k"],
                                             ["k"], how=how)
    for g, p in zip(got, plain):
        np.testing.assert_array_equal(g, p)


def _file_bytes(path):
    out = {}
    for name in sorted(os.listdir(path)):
        if name.endswith(".parquet"):
            with open(os.path.join(path, name), "rb") as f:
                out[name] = f.read()
    return out


@pytest.mark.parametrize("keys", [["key"], ["key", "s"], ["x"]])
def test_index_files_byte_equal_with_and_without_library(
        lib, jax_lib, tmp_path, monkeypatch, keys):
    """The port's create path with the library (the native-host lane),
    without it (the torch lane on the CPU), and the JAX package's with
    its library write the same files, byte for byte."""
    rng = np.random.default_rng(len(keys))
    n = 12_000
    table = pa.table({
        "key": rng.integers(0, n // 3, n).astype(np.int64),
        "s": pa.array([None if i % 17 == 0 else f"s{i % 211}"
                       for i in range(n)]),
        "x": rng.standard_normal(n),
        "id": np.arange(n, dtype=np.int64)})
    src = tmp_path / "src"
    src.mkdir()
    pq.write_table(table.slice(0, n // 2), str(src / "a.parquet"))
    pq.write_table(table.slice(n // 2), str(src / "b.parquet"))
    files = [str(src / "a.parquet"), str(src / "b.parquet")]
    columns = ["key", "s", "x", "id"]
    monkeypatch.setattr(jbuilder, "BUILD_MIN_DEVICE_ROWS", 0)
    monkeypatch.setattr(builder, "BUILD_MIN_DEVICE_ROWS", 0)
    assert jbuilder.build_lane(n) == "native-host"
    jbuilder.write_bucketed_from_files(files, columns, keys, 16,
                                       str(tmp_path / "jax"))
    assert builder.build_lane(n, CPU) == "native-host"
    builder.write_bucketed_from_files(files, columns, keys, 16,
                                      str(tmp_path / "native"), CPU)
    _no_native(monkeypatch)
    assert builder.build_lane(n, CPU) == "device"
    builder.write_bucketed_from_files(files, columns, keys, 16,
                                      str(tmp_path / "torch"), CPU)
    want = _file_bytes(tmp_path / "jax")
    assert want
    assert _file_bytes(tmp_path / "native") == want
    assert _file_bytes(tmp_path / "torch") == want
