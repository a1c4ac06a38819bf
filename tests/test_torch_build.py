"""The PyTorch port's build permutation and bucket files against the JAX
package's, on the CPU.

The same Arrow tables, made from a seed with numpy, are built by both
packages: the permutation, the per-bucket `starts`/`ends`, the bucket file
names and the decoded rows of every file (in order) must be identical.
"""

import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
from torch_suites import jax_counters_guard  # noqa: E402,F401
import torch

from hyperspace_tpu.io import builder as jbuilder
from hyperspace_tpu.io import columnar as jcol
from hyperspace_tpu.ops import build as jbuild

# The suite runs in parallel worker processes; one torch thread per worker
# keeps torch's spinning OpenMP pool from starving the other workers.
torch.set_num_threads(1)

from hyperspace_tpu_torch.io import builder as tbuilder
from hyperspace_tpu_torch.io import columnar as tcol
from hyperspace_tpu_torch.ops import build as tbuild

CPU = torch.device("cpu")


def _table(kind, n, seed):
    rng = np.random.default_rng(seed)
    if kind == "int64":
        return pa.table({
            "k": rng.integers(0, max(1, n // 4), n).astype(np.int64),
            "x": rng.standard_normal(n)}), ["k"]
    if kind == "signed_int64":
        return pa.table({
            "k": rng.integers(-2**62, 2**62, n).astype(np.int64),
            "x": rng.standard_normal(n)}), ["k"]
    if kind == "float64":
        pool = np.array([0.0, -0.0, np.nan, np.inf, -np.inf, 1.0, -1.0,
                         2.5], dtype=np.float64)
        return pa.table({"k": pool[rng.integers(0, len(pool), n)],
                         "i": np.arange(n, dtype=np.int64)}), ["k"]
    if kind == "nullable_multi":
        return pa.table({
            "k": pa.array(rng.integers(0, 700, n).astype(np.int64),
                          mask=rng.random(n) < 0.1),
            "s": pa.array([None if i % 31 == 0 else "v%d" % (i % 53)
                           for i in range(n)], type=pa.string()),
            "x": rng.standard_normal(n)}), ["k", "s"]
    if kind == "int32_string":
        return pa.table({
            "a": rng.integers(-50, 50, n).astype(np.int32),
            "s": pa.array([f"w{int(x)}" for x in rng.integers(0, 40, n)]),
            "x": rng.standard_normal(n)}), ["a", "s"]
    raise AssertionError(kind)


KINDS = ("int64", "signed_int64", "float64", "nullable_multi",
         "int32_string")


@pytest.mark.parametrize("num_buckets", [8, 200])
@pytest.mark.parametrize("n", [1, 129, 5000])
@pytest.mark.parametrize("kind", KINDS)
def test_build_permutation_matches_jax(kind, n, num_buckets):
    table, keys = _table(kind, n, KINDS.index(kind))
    jchunks, jstarts, jends = jbuild.build_permutation(
        jcol.from_arrow(table), keys, num_buckets)
    tperm, tstarts, tends = tbuild.build_permutation(
        tcol.from_arrow(table, device=CPU), keys, num_buckets)
    jperm = np.concatenate([np.asarray(c) for c in jchunks])
    assert (tperm.numpy() == jperm).all()
    assert (tstarts.numpy() == np.asarray(jstarts)).all()
    assert (tends.numpy() == np.asarray(jends)).all()


def _files(path):
    return sorted(f for f in os.listdir(path) if f.endswith(".parquet"))


def _same_rows(got, expected) -> bool:
    """Decoded tables equal row by row, in order (NaN equals NaN, -0.0
    is kept apart from +0.0 by its sign bit)."""
    if got.schema != expected.schema or got.num_rows != expected.num_rows:
        return False
    for name in expected.column_names:
        a, b = got.column(name), expected.column(name)
        if a.null_count or b.null_count:
            if a.is_null().to_pylist() != b.is_null().to_pylist():
                return False
        if pa.types.is_floating(b.type):
            av = a.to_numpy(zero_copy_only=False)
            bv = b.to_numpy(zero_copy_only=False)
            if av.tobytes() != bv.tobytes():
                return False
        elif a.to_pylist() != b.to_pylist():
            return False
    return True


@pytest.mark.parametrize("lane", ["host", "device"])
@pytest.mark.parametrize("kind", KINDS)
def test_bucket_files_match_jax(tmp_path, monkeypatch, kind, lane):
    table, keys = _table(kind, 3000, 100 + KINDS.index(kind))
    if lane == "device":
        monkeypatch.setattr(jbuilder, "BUILD_MIN_DEVICE_ROWS", 0)
        monkeypatch.setattr(tbuilder, "BUILD_MIN_DEVICE_ROWS", 0)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    jbuilder.write_bucketed_table(table, keys, 16, jdir)
    tbuilder.write_bucketed_table(table, keys, 16, tdir, device=CPU)
    assert _files(tdir) == _files(jdir)
    assert _files(tdir)
    for name in _files(jdir):
        expected = pq.read_table(os.path.join(jdir, name))
        got = pq.read_table(os.path.join(tdir, name))
        assert _same_rows(got, expected), name


def test_narrow_transport_hashes_like_the_wide_path():
    """An int64 key that fits in uint32 ships as one `lo32` lane; its
    bucket ids and permutation equal the wide two-lane path's."""
    table, keys = _table("int64", 5000, 7)
    tree = tbuilder._stage_key_tree(table, keys, CPU)
    assert "lo32" in tree["k"]
    narrow, nstarts, _ = tbuild.permutation_from_tree(tree, keys, 64)
    wide, wstarts, _ = tbuild.build_permutation(
        tcol.from_arrow(table, device=CPU), keys, 64)
    assert (narrow == wide).all()
    assert (nstarts == wstarts).all()


def test_build_lane_thresholds(monkeypatch):
    from hyperspace_tpu_torch import native as tnative

    n = tbuilder.BUILD_MIN_DEVICE_ROWS
    cuda = torch.device("cuda")
    for device in (None, CPU, cuda):
        assert tbuilder.build_lane(n - 1, device) == "host-lexsort"
    # A CUDA session keeps the device lane (the hash kernel); a CPU
    # session takes the native radix sort when the library loads.
    assert tbuilder.build_lane(n, cuda) == "device"
    assert tbuilder.build_lane(n, CPU) == "native-host"
    assert tbuilder.build_lane(n) == "native-host"
    monkeypatch.setattr(tnative, "get_lib", lambda: None)
    assert tbuilder.build_lane(n, CPU) == "device"
    assert tbuilder.build_lane(n) == "host-lexsort"
    assert tbuilder.BUILD_MIN_DEVICE_ROWS == jbuilder.BUILD_MIN_DEVICE_ROWS
