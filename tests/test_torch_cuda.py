"""`hyperspace_tpu_torch` on a CUDA card: the hand-written kernels against
their plain versions, and the card's build, filter, Exchange, join,
incremental-refresh, compaction-sort, hybrid-join, aggregate, sort,
window and set-operation lanes against the CPU's.

Marked `cuda`; each test skips where there is no card. On the machine
with the card (which has no JAX, so the JAX-loading conftest is skipped):

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda
"""

import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from hyperspace_tpu_torch.io import builder, columnar
from hyperspace_tpu_torch.ops.cuda import (hash_kernel, partition_kernel,
                                           run_bounds_kernel)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("n", [1, 129, 70_000, 1 << 20])
@pytest.mark.parametrize("n_lanes", [1, 2, 5])
def test_kernel_equals_plain_version(card, n, n_lanes):
    rng = np.random.default_rng([n, n_lanes])
    host = rng.integers(-2**31, 2**31, (n_lanes, n)).astype(np.int32)
    lanes = torch.from_numpy(host).to(card)
    before = hash_kernel.hash_lanes_to_buckets.launches
    for num_buckets in (8, 200, 1024):
        got = hash_kernel.hash_lanes_to_buckets(lanes, num_buckets)
        torch.cuda.synchronize()
        want = hash_kernel.hash_lanes_to_buckets_reference(
            torch.from_numpy(host), num_buckets)
        assert got.device.type == "cuda" and got.dtype == torch.int32
        assert (got.cpu() == want).all()
    assert hash_kernel.hash_lanes_to_buckets.launches == before + 3


def _flags_of_lengths(lengths):
    """The T-1 difference flags of a sorted sequence with runs `lengths`."""
    starts = np.zeros(int(np.sum(lengths)), dtype=bool)
    starts[np.cumsum(lengths)[:-1]] = True
    return starts[1:]


def _tpch_runs(total, seed):
    """Flags of `total` elements in runs of 1-7 (lines an order)."""
    lengths = np.random.default_rng(seed).integers(1, 8, total // 3)
    lengths = lengths[np.cumsum(lengths) < total]
    return _flags_of_lengths(np.r_[lengths, total - lengths.sum()])


_TILE = 4096  # the kernel's tile (`csrc/run_bounds.cu`)
RUN_BOUNDS_CASES = {
    "T=1": lambda: np.zeros(0, dtype=bool),
    "T=2 one run": lambda: np.array([False]),
    "T=2 two runs": lambda: np.array([True]),
    "one run over all": lambda: np.zeros(3 * _TILE, dtype=bool),
    "all distinct": lambda: np.ones(2 * _TILE + 5, dtype=bool),
    "runs of 1-7": lambda: _tpch_runs(100_003, 1),
    "run across a tile edge": lambda: _flags_of_lengths(
        [_TILE - 10, 25, _TILE, 7]),
    "run over three tiles": lambda: _flags_of_lengths(
        [3, 3 * _TILE + 100, 2, 40]),
    "run over 40 tiles": lambda: _flags_of_lengths(
        [5, 40 * _TILE, 3, 33 * _TILE, 9]),
    "T not a tile multiple": lambda: np.random.default_rng(2).random(
        2 * _TILE + 999) < 0.5,
    "random": lambda: np.random.default_rng(3).random(1 << 20) < 0.1,
    "q5's join, T = 6,226,893": lambda: _tpch_runs(6_226_893, 5),
}


@pytest.mark.parametrize("case", list(RUN_BOUNDS_CASES))
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "offset view"])
def test_run_bounds_kernel_equals_plain_version(card, case, offset):
    """The kernel against its plain version on the CPU, bit for bit; the
    flags also as a view one byte into a buffer."""
    flags = RUN_BOUNDS_CASES[case]()
    buf = torch.zeros(len(flags) + offset, dtype=torch.bool, device=card)
    differs = buf[offset:]
    differs.copy_(torch.from_numpy(flags))
    before = run_bounds_kernel.run_bounds.launches
    first, last = run_bounds_kernel.run_bounds(differs)
    torch.cuda.synchronize()
    want_first, want_last = run_bounds_kernel.run_bounds_reference(
        torch.from_numpy(flags))
    assert first.device.type == last.device.type == "cuda"
    assert first.dtype == last.dtype == torch.int64
    assert torch.equal(first.cpu(), want_first)
    assert torch.equal(last.cpu(), want_last)
    assert run_bounds_kernel.run_bounds.launches == before + (len(flags) > 0)


@pytest.mark.parametrize("how", ["inner", "left_outer"])
@pytest.mark.parametrize("keys", [["key"], ["key", "f"]],
                         ids=["exact", "hashed"])
def test_card_counting_join_equals_cpu_through_the_kernel(card, how, keys):
    """The counting join on the card (narrow keys: the exact lane sort;
    (int64, float64): 5 lanes, the hashed path) gives the CPU's pairs,
    and its run bounds come from the kernel, counted by the seam."""
    from hyperspace_tpu_torch import telemetry
    from hyperspace_tpu_torch.ops import join
    from hyperspace_tpu_torch.telemetry import compilation

    rng = np.random.default_rng([len(keys), len(how)])
    sides = []
    for n in (50_000, 30_000):
        key = rng.integers(0, 12_000, n).astype(np.int64)
        sides.append(pa.table({"key": pa.array(key, mask=np.arange(n) % 37
                                               == 0),
                               "f": (key % 5).astype(np.float64)}))
    cpu = [columnar.from_arrow(t, device=torch.device("cpu")) for t in sides]
    gpu = [columnar.from_arrow(t, device=card) for t in sides]
    n_lanes = len(join._join_lane_operands(*cpu, keys, keys)[0])
    assert (n_lanes >= join.HASH_MATCH_MIN_LANES) == (len(keys) == 2)
    want_li, want_ri = join.counting_join_batch_indices(*cpu, keys, keys,
                                                        how=how)
    compilation.resolve_pending()
    reg = telemetry.get_registry()
    calls0 = reg.counter("device.cuda.run_bounds.dispatches").value
    before = run_bounds_kernel.run_bounds.launches
    li, ri = join.counting_join_batch_indices(*gpu, keys, keys, how=how)
    assert len(want_li) > 50_000
    assert torch.equal(li.cpu(), want_li) and torch.equal(ri.cpu(), want_ri)
    assert run_bounds_kernel.run_bounds.launches == before + 1
    compilation.resolve_pending()
    assert reg.counter("device.cuda.run_bounds.dispatches").value \
        == calls0 + 1


def _table(n):
    rng = np.random.default_rng(5)
    return pa.table({
        "k": rng.integers(0, n // 4, n).astype(np.int64),
        "s": pa.array([None if i % 29 == 0 else f"v{i % 61}"
                       for i in range(n)]),
        "x": rng.standard_normal(n)})


def test_card_build_writes_the_cpu_layout(card, tmp_path, monkeypatch):
    monkeypatch.setattr(builder, "BUILD_MIN_DEVICE_ROWS", 0)
    table = _table(20_000)
    before = hash_kernel.hash_lanes_to_buckets.launches
    for keys in (["k"], ["k", "s"]):
        gpu_dir = str(tmp_path / f"gpu_{len(keys)}")
        cpu_dir = str(tmp_path / f"cpu_{len(keys)}")
        builder.write_bucketed_table(table, keys, 16, gpu_dir, device=card)
        builder.write_bucketed_table(table, keys, 16, cpu_dir,
                                     device=torch.device("cpu"))
        names = sorted(os.listdir(gpu_dir))
        assert names == sorted(os.listdir(cpu_dir))
        for name in names:
            assert pq.read_table(os.path.join(gpu_dir, name)).equals(
                pq.read_table(os.path.join(cpu_dir, name)))
    assert hash_kernel.hash_lanes_to_buckets.launches == before + 2


def test_card_filter_equals_cpu_filter(card):
    from hyperspace_tpu_torch.engine.compiler import apply_filter
    from hyperspace_tpu_torch.plan.expr import col, lit

    table = _table(50_000)
    cond = ((col("k") >= lit(100)) & (col("x") > lit(0.5))) \
        | (col("s") == lit("v7"))
    gpu = apply_filter(columnar.from_arrow(table, device=card), cond)
    cpu = apply_filter(columnar.from_arrow(table,
                                           device=torch.device("cpu")),
                       cond)
    assert gpu.device.type == "cuda"
    assert columnar.to_arrow(gpu).equals(columnar.to_arrow(cpu))


@pytest.mark.parametrize("n", [1, 129, 70_000, 1 << 20])
@pytest.mark.parametrize("n_lanes", [1, 2, 5])
def test_partition_kernel_equals_plain_version(card, n, n_lanes):
    rng = np.random.default_rng([n, n_lanes, 1])
    host = rng.integers(-2**31, 2**31, (n_lanes, n)).astype(np.int32)
    lanes = torch.from_numpy(host).to(card)
    before = partition_kernel.partition_ids_and_histogram.launches
    for num_buckets in (8, 200, 1024):
        ids, lengths = partition_kernel.partition_ids_and_histogram(
            lanes, num_buckets)
        torch.cuda.synchronize()
        want_ids, want_lengths = \
            partition_kernel.partition_ids_and_histogram_reference(
                torch.from_numpy(host), num_buckets)
        assert ids.device.type == "cuda" and ids.dtype == torch.int32
        assert lengths.dtype == torch.int64
        assert (ids.cpu() == want_ids).all()
        assert (lengths.cpu() == want_lengths).all()
        assert int(lengths.sum()) == n
    assert partition_kernel.partition_ids_and_histogram.launches \
        == before + 3


@pytest.mark.parametrize("num_buckets", [200, 2048])
def test_card_exchange_equals_cpu_exchange(card, num_buckets):
    """The fused kernel (<= 1024 partitions) and the two-pass path (hash
    kernel + bincount) group rows as the CPU does."""
    from hyperspace_tpu_torch.engine.physical import ExchangeExec

    table = _table(50_000)
    exchange = ExchangeExec(["k", "s"], num_buckets, None)
    fused = partition_kernel.partition_ids_and_histogram.launches
    two_pass = hash_kernel.hash_lanes_to_buckets.launches
    gpu, gpu_lengths = exchange.partition(
        columnar.from_arrow(table, device=card))
    cpu, cpu_lengths = exchange.partition(
        columnar.from_arrow(table, device=torch.device("cpu")))
    assert gpu.device.type == "cuda"
    assert (gpu_lengths == cpu_lengths).all()
    assert columnar.to_arrow(gpu).equals(columnar.to_arrow(cpu))
    kernel_route = num_buckets <= partition_kernel.MAX_KERNEL_BUCKETS
    assert partition_kernel.partition_ids_and_histogram.launches \
        == fused + kernel_route
    assert hash_kernel.hash_lanes_to_buckets.launches \
        == two_pass + (not kernel_route)


def test_card_mismatched_bucket_join_equals_cpu(card, tmp_path):
    """A join of a 16-bucket index with an 8-bucket index: on the card the
    8-bucket side is re-bucketed through the partition kernel, and the
    rows equal the same join on the CPU."""
    import hyperspace_tpu_torch as ths

    rng = np.random.default_rng(9)
    n = 60_000
    for name, size in (("left", n), ("right", n // 2)):
        os.makedirs(tmp_path / name)
        pq.write_table(pa.table({
            "key": rng.integers(0, n // 4, size).astype(np.int64),
            "v": rng.random(size)}), str(tmp_path / name / "a.parquet"))
    rows = {}
    for device in ("cuda", "cpu"):
        sess = ths.HyperspaceSession(ths.HyperspaceConf({
            "spark.hyperspace.warehouse.dir": str(tmp_path / device),
            "spark.hyperspace.execution.min.device.rows": "0",
            "spark.hyperspace.broadcast.threshold": "-1"}), device=device)
        hs = ths.Hyperspace(sess)
        dfs = {}
        for name, buckets in (("left", 16), ("right", 8)):
            sess.conf.set("spark.hyperspace.index.num.buckets", str(buckets))
            dfs[name] = sess.read_parquet(str(tmp_path / name))
            hs.create_index(dfs[name], ths.IndexConfig(f"{name}Idx", ["key"],
                                                       ["v"]))
        sess.enable_hyperspace()
        before = partition_kernel.partition_ids_and_histogram.launches
        table, metrics = dfs["left"].join(dfs["right"], on="key").collect(
            with_metrics=True)
        assert "Exchange" in [op.name for op in metrics.operators]
        launched = partition_kernel.partition_ids_and_histogram.launches
        assert (launched > before) == (device == "cuda")
        ordered = table.sort_by([(c, "ascending")
                                 for c in table.column_names])
        rows[device] = ordered
    assert rows["cuda"].num_rows > n
    assert rows["cuda"].equals(rows["cpu"])


def _files(path):
    return sorted(f for f in os.listdir(path) if f.endswith(".parquet"))


def test_card_incremental_delta_equals_host_lane(card, tmp_path,
                                                 monkeypatch):
    """A 1,048,576-row incremental delta builds on the card (the hash
    kernel launched) and writes the host lane's delta files, byte for
    byte."""
    import hyperspace_tpu_torch as ths

    rng = np.random.default_rng(13)
    src = tmp_path / "src"
    os.makedirs(src)

    def part(name, n):
        pq.write_table(pa.table({
            "key": rng.integers(0, 1 << 18, n).astype(np.int64),
            "score": rng.random(n)}), str(src / name))

    part("part-0.parquet", 1 << 16)
    sessions = {}
    for device in ("cuda", "cpu"):
        sess = ths.HyperspaceSession(ths.HyperspaceConf({
            "spark.hyperspace.warehouse.dir": str(tmp_path / device)}),
            device=device)
        ths.Hyperspace(sess).create_index(
            sess.read_parquet(str(src)),
            ths.IndexConfig("inc", ["key"], ["score"]))
        sessions[device] = sess
    part("part-1.parquet", 1 << 20)
    for device, sess in sessions.items():
        if device == "cpu":
            # The host lane: the delta's permutation from numpy.
            monkeypatch.setattr(builder, "BUILD_MIN_DEVICE_ROWS", 1 << 30)
        before = hash_kernel.hash_lanes_to_buckets.launches
        ths.Hyperspace(sess).refresh_index("inc", mode="incremental")
        launched = hash_kernel.hash_lanes_to_buckets.launches - before
        assert (launched > 0) == (device == "cuda")
    gpu = tmp_path / "cuda" / "indexes" / "inc" / "v__=1"
    cpu = tmp_path / "cpu" / "indexes" / "inc" / "v__=1"
    names = _files(gpu)
    assert names == _files(cpu) and any("-delta1" in f for f in names)
    for name in names:
        assert (gpu / name).read_bytes() == (cpu / name).read_bytes(), name


@pytest.mark.parametrize("keys", [["k"], ["k", "s"], ["x"]])
def test_card_bucket_sort_permutation_equals_cpu(card, keys):
    from hyperspace_tpu_torch.ops import merge

    rng = np.random.default_rng(len(keys))
    lengths = rng.integers(0, 5000, 200).astype(np.int64)
    lengths[::7] = 0
    table = _table(int(lengths.sum()))
    (gpu,), gstarts, gends = merge.bucket_sort_permutation(
        columnar.from_arrow(table, device=card), keys, lengths)
    (cpu,), cstarts, cends = merge.bucket_sort_permutation(
        columnar.from_arrow(table, device=torch.device("cpu")), keys,
        lengths)
    assert gpu.device.type == "cuda"
    assert torch.equal(gpu.cpu(), cpu)
    assert (gstarts == cstarts).all() and (gends == cends).all()


def test_card_hybrid_left_outer_join_equals_cpu(card, tmp_path):
    """A left_outer join with a stale index on the right: the appended
    branch of its hybrid scan is re-bucketed on the card through the
    partition kernel, and the rows equal the same query on the CPU."""
    import hyperspace_tpu_torch as ths

    rng = np.random.default_rng(21)
    n = 60_000
    for name, size in (("left", n // 2), ("right", n)):
        os.makedirs(tmp_path / name)
        pq.write_table(pa.table({
            "key": rng.integers(0, n // 4, size).astype(np.int64),
            "v": rng.random(size)}), str(tmp_path / name / "a.parquet"))
    sessions = {}
    for device in ("cuda", "cpu"):
        sess = ths.HyperspaceSession(ths.HyperspaceConf({
            "spark.hyperspace.warehouse.dir": str(tmp_path / device),
            "spark.hyperspace.execution.min.device.rows": "0",
            "spark.hyperspace.index.num.buckets": "16",
            "spark.hyperspace.index.hybridscan.enabled": "true",
            "spark.hyperspace.broadcast.threshold": "-1"}), device=device)
        for name in ("left", "right"):
            ths.Hyperspace(sess).create_index(
                sess.read_parquet(str(tmp_path / name)),
                ths.IndexConfig(f"{name}Idx", ["key"], ["v"]))
        sessions[device] = sess
    pq.write_table(pa.table({
        "key": rng.integers(0, n // 4, 9000).astype(np.int64),
        "v": rng.random(9000)}), str(tmp_path / "right" / "b.parquet"))
    rows = {}
    for device, sess in sessions.items():
        sess.enable_hyperspace()
        left = sess.read_parquet(str(tmp_path / "left"))
        right = sess.read_parquet(str(tmp_path / "right"))
        before = partition_kernel.partition_ids_and_histogram.launches
        table, metrics = left.join(right, on="key", how="left_outer") \
            .collect(with_metrics=True)
        names = [op.name for op in metrics.operators]
        assert "Union" in names and "Exchange" in names
        launched = partition_kernel.partition_ids_and_histogram.launches
        assert (launched > before) == (device == "cuda")
        rows[device] = table.sort_by([(c, "ascending")
                                      for c in table.column_names])
    assert rows["cuda"].num_rows >= n // 2
    assert rows["cuda"].equals(rows["cpu"])


def _analytic_table(n):
    rng = np.random.default_rng([17, n])
    null = rng.random(n) < 0.1
    return pa.table({
        "id": np.arange(n, dtype=np.int64),
        "g": rng.integers(0, 50, n).astype(np.int64),
        "s": pa.array([f"w{i}" for i in rng.integers(0, 40, n)],
                      mask=rng.random(n) < 0.05),
        "d": rng.integers(8000, 10000, n).astype(np.int32),
        "x": rng.standard_normal(n) * 1e4,
        "nx": pa.array(rng.standard_normal(n), mask=null),
        "q": pa.array(rng.integers(1, 50, n).astype(np.int64), mask=null)})


@pytest.mark.parametrize("group", [[], ["g"], ["s", "d"],
                                   ["g", "s", "d", "q"]],
                         ids=lambda g: "+".join(g) or "global")
def test_card_group_aggregate_equals_cpu(card, group):
    """Every function on the card against the same call on the CPU: group
    keys, counts and integers exactly, float64 within rtol=1e-9 (the
    segment sums add in another order on each device)."""
    from hyperspace_tpu_torch.ops.aggregate import group_aggregate
    from hyperspace_tpu_torch.plan.nodes import Aggregate, AggSpec

    table = _analytic_table(200_000)
    specs = [AggSpec("count", "*", "n"), AggSpec("count", "q", "nq"),
             AggSpec("count_distinct", "s", "ds"),
             AggSpec("sum", "x", "sx"), AggSpec("sum", "q", "sq"),
             AggSpec("avg", "nx", "ax"), AggSpec("stddev", "x", "sdx"),
             AggSpec("min", "d", "mind"), AggSpec("max", "nx", "maxx")]
    out = {}
    for device in (card, torch.device("cpu")):
        batch = columnar.from_arrow(table, device=device)

        class _Child:
            schema = batch.schema
        schema = Aggregate(group, specs, _Child()).schema
        got = group_aggregate(batch, group, specs, schema)
        assert got.device.type == device.type
        out[device.type] = columnar.to_arrow(got)
    gpu, cpu = out["cuda"], out["cpu"]
    assert gpu.num_rows == cpu.num_rows > 0
    for name in cpu.column_names:
        if pa.types.is_floating(cpu.schema.field(name).type):
            g = gpu.column(name).to_numpy(zero_copy_only=False)
            c = cpu.column(name).to_numpy(zero_copy_only=False)
            assert np.allclose(g, c, rtol=1e-9, atol=0, equal_nan=True), name
        else:
            assert gpu.column(name).equals(cpu.column(name)), name


def test_card_float_sum_repeats_bit_for_bit(card):
    """The same float64 sum on the same data gives the same bits twice."""
    from hyperspace_tpu_torch.ops.aggregate import group_aggregate
    from hyperspace_tpu_torch.plan.nodes import Aggregate, AggSpec

    batch = columnar.from_arrow(_analytic_table(1 << 20), device=card)

    class _Child:
        schema = batch.schema
    for group in ([], ["g"]):
        specs = [AggSpec("sum", "x", "sx"), AggSpec("avg", "nx", "ax")]
        schema = Aggregate(group, specs, _Child()).schema
        runs = [columnar.to_arrow(group_aggregate(batch, group, specs,
                                                  schema))
                for _ in range(2)]
        assert runs[0].equals(runs[1])


@pytest.mark.parametrize("keys", [["g", "-x"], ["-s", "d", "id"],
                                  ["-q", "nx"]])
def test_card_sort_and_topk_equal_cpu(card, keys):
    """`sort_batch` and `topk_batch` on the card against the CPU: the same
    rows in the same order; the threshold top-k comes back on the host."""
    from hyperspace_tpu_torch.ops.sort import sort_batch, topk_batch

    table = _analytic_table(300_000)
    gpu_in = columnar.from_arrow(table, device=card)
    cpu_in = columnar.from_arrow(table, device=torch.device("cpu"))
    gpu = sort_batch(gpu_in, keys)
    assert gpu.device.type == "cuda"
    assert columnar.to_arrow(gpu).equals(
        columnar.to_arrow(sort_batch(cpu_in, keys)))
    for k in (1, 100, 5000):
        got = topk_batch(gpu_in, keys, k)
        assert got.is_host
        assert columnar.to_arrow(got).equals(
            columnar.to_arrow(topk_batch(cpu_in, keys, k)))


@pytest.mark.parametrize("partition,order", [
    (["g"], ["-x"]), (["s"], ["q", "-d"]), ([], ["-q"]), (["g", "s"], [])],
    ids=["g/-x", "s/q,-d", "none/-q", "g,s/none"])
def test_card_window_equals_host_lane(card, partition, order):
    """`window_compute` on the card at 1,048,576 rows against the host
    (numpy) lane: ties (low-cardinality keys) and nulls in partition and
    order keys; ranks, counts and integers exactly, float64 within
    rtol=1e-9 (partition sums add in another order on each lane)."""
    from hyperspace_tpu_torch.ops.window import window_compute
    from hyperspace_tpu_torch.plan.nodes import AggSpec, Window

    table = _analytic_table(1 << 20)
    specs = ([AggSpec("rank", "*", "rk"), AggSpec("dense_rank", "*", "drk")]
             if order else [])
    specs += [AggSpec("row_number", "*", "rn"), AggSpec("count", "*", "n"),
              AggSpec("count", "q", "nq"), AggSpec("sum", "q", "sq"),
              AggSpec("sum", "x", "sx"), AggSpec("avg", "nx", "ax"),
              AggSpec("min", "d", "mind"), AggSpec("max", "nx", "maxx")]
    out = {}
    for lane, device in (("card", card), ("host", None)):
        batch = columnar.from_arrow(table, device=device)

        class _Child:
            schema = batch.schema
        schema = Window(partition, order, specs, _Child()).schema
        got = window_compute(batch, partition, order, specs, schema)
        assert got.is_host == (lane == "host")
        out[lane] = columnar.to_arrow(got)
    gpu, cpu = out["card"], out["host"]
    assert gpu.num_rows == cpu.num_rows == 1 << 20
    for name in cpu.column_names:
        if pa.types.is_floating(cpu.schema.field(name).type):
            g = gpu.column(name).to_numpy(zero_copy_only=False)
            c = cpu.column(name).to_numpy(zero_copy_only=False)
            assert np.allclose(g, c, rtol=1e-9, atol=0, equal_nan=True), name
        else:
            assert gpu.column(name).equals(cpu.column(name)), name


@pytest.mark.parametrize("names", [["g"], ["s", "q"], ["g", "s", "d", "nx"]])
@pytest.mark.parametrize("anti", [False, True], ids=["intersect", "except"])
def test_card_set_op_indices_equal_host_lane(card, names, anti):
    """`set_op_indices` on the card at 1,048,576 left rows against the host
    lane: the same left-row indices in the same first-occurrence order,
    with duplicates, nulls (NULL equals NULL) and string sides whose
    dictionaries differ."""
    from hyperspace_tpu_torch.ops.setops import set_op_indices

    left = _analytic_table(1 << 20)
    rng = np.random.default_rng(23)
    right = _analytic_table(300_000).take(
        rng.integers(0, 300_000, 200_000))
    right = right.set_column(
        right.column_names.index("s"), "s",
        pa.array([f"w{i}" for i in rng.integers(20, 60, right.num_rows)],
                 mask=rng.random(right.num_rows) < 0.05))
    # No right row has a `g` divisible by 7, so EXCEPT on `g` keeps rows.
    right = right.filter(np.asarray(right.column("g")) % 7 != 0)
    got = set_op_indices(columnar.from_arrow(left, device=card),
                         columnar.from_arrow(right, device=card), names,
                         anti)
    want = set_op_indices(columnar.from_arrow(left),
                          columnar.from_arrow(right), names, anti)
    assert len(want) > 0
    assert isinstance(got, torch.Tensor) and got.device.type == "cuda"
    assert got.cpu().numpy().tolist() == want.tolist()


@pytest.mark.parametrize("dtype", [np.int64, np.float64, np.int32, np.bool_])
def test_card_engine_round_trips_pinned_chunks(card, dtype):
    """The transfer engine on the card: chunked copies from reused pinned
    staging buffers (several chunks per buffer over the put) land every
    byte, cast or not, and a prefetched D2H fetch returns them."""
    from hyperspace_tpu_torch.io import transfer

    engine = transfer.set_engine(transfer.TransferEngine(
        chunk_bytes=1 << 20, inflight_bytes=4 << 20, threads=2))
    try:
        rng = np.random.default_rng(31)
        src = rng.integers(-2**40, 2**40, 3_000_001)
        want = src.astype(dtype)
        placed = [engine.put(want, card),
                  engine.put(transfer.HostCast(src, dtype), card)]
        torch.cuda.synchronize()
        stats = dict(engine.stats)
        assert stats["staging_reused"] > 0, stats
        assert stats["staging_allocated"] <= 2 * engine.threads + 2
        for got in placed:
            assert got.device.type == "cuda"
            engine.prefetch(got)
            assert np.array_equal(engine.fetch(got), want)
            assert np.array_equal(got.cpu().numpy(), want)
    finally:
        transfer.reset_engine()


def _index_session(card, tmp_path):
    import hyperspace_tpu_torch as ths

    rng = np.random.default_rng(41)
    src = tmp_path / "src"
    src.mkdir()
    pq.write_table(pa.table({
        "key": rng.integers(0, 500, 200_000).astype(np.int64),
        "val": rng.random(200_000),
        "s": [f"s{i % 97}" for i in range(200_000)]}),
        str(src / "part-0.parquet"))
    sess = ths.HyperspaceSession(ths.HyperspaceConf({
        "spark.hyperspace.warehouse.dir": str(tmp_path / "wh"),
        "spark.hyperspace.execution.min.device.rows": "0"}), device=card)
    df = sess.read_parquet(str(src))
    ths.Hyperspace(sess).create_index(
        df, ths.IndexConfig("cidx", ["key"], ["val", "s"]))
    sess.enable_hyperspace()
    return sess, df


def test_card_warm_scan_is_a_cuda_segment_hit(card, tmp_path):
    """A warm index Scan on the card returns the cached CUDA tensors and
    crosses no link: a segment-cache hit adds no `link.h2d.chunks`."""
    from hyperspace_tpu_torch import telemetry
    from hyperspace_tpu_torch.engine.physical import plan_physical
    from hyperspace_tpu_torch.io import segcache
    from hyperspace_tpu_torch.plan.expr import col, lit

    segcache.set_cache(segcache.SegmentCache())
    try:
        sess, df = _index_session(card, tmp_path)
        frame = df.filter(col("key") >= lit(100)).select("key", "val", "s")
        cold = frame.collect()
        reg = telemetry.get_registry()
        chunks0 = reg.counter("link.h2d.chunks").value
        hits0 = reg.counter("cache.segments.hits").value
        plan = sess.optimize(frame.plan)
        scan = [n for n in plan_physical(plan, conf=sess.conf).collect()
                if n.name == "Scan"][0]
        batch = scan.execute()
        assert reg.counter("cache.segments.hits").value == hits0 + 1
        assert reg.counter("link.h2d.chunks").value == chunks0
        for c in batch.columns.values():
            assert c.data.device.type == "cuda"
        warm = frame.collect()
        assert reg.counter("link.h2d.chunks").value == chunks0
        assert warm.equals(cold)
        sess.disable_hyperspace()
        assert sorted(warm.to_pylist(), key=repr) == sorted(
            frame.collect().to_pylist(), key=repr)
    finally:
        segcache.set_cache(segcache.SegmentCache())


@pytest.mark.parametrize("nulls", [False, True])
def test_card_sketch_blob_equals_host_lane(card, tmp_path, nulls):
    """A data-skipping build whose sketches reduce on the card writes the
    host lane's `_hs_sketches` blob byte for byte, and each column's
    zones and bloom words on the card equal the host lane's."""
    from hyperspace_tpu_torch import (DataSkippingIndexConfig, Hyperspace,
                                      HyperspaceConf, HyperspaceSession)
    from hyperspace_tpu_torch.ops import sketch
    from hyperspace_tpu_torch.plan.schema import Schema

    src = tmp_path / "src"
    src.mkdir()
    rng = np.random.default_rng(8)
    for i in range(3):
        n = 50_000
        x = rng.standard_normal(n)
        x[rng.random(n) < 0.01] = np.nan
        t = pa.table({
            "k": np.arange(i * n, (i + 1) * n, dtype=np.int64),
            "s": pa.array([None if nulls and j % 31 == 0 else f"v{j % 97}"
                           for j in range(n)]),
            "x": x, "b": rng.random(n) < 0.5,
            "g": rng.integers(-9, 9, n).astype(np.int32)})
        pq.write_table(t, str(src / f"part-{i}.parquet"))
        schema = Schema.from_arrow(t.schema)
        host = columnar.from_arrow(t, schema, device=None)
        dev = columnar.from_arrow(t, schema, device=card)
        for name in t.column_names:
            assert sketch.zones(dev.column(name)) == \
                sketch.zones(host.column(name)), name
            assert np.array_equal(
                sketch.bloom_build(dev.column(name), 1 << 16),
                sketch.bloom_build(host.column(name), 1 << 16)), name
    blobs = []
    for lane, min_rows in (("device", "0"), ("host", str(1 << 30))):
        sess = HyperspaceSession(HyperspaceConf({
            "spark.hyperspace.warehouse.dir": str(tmp_path / lane),
            "spark.hyperspace.execution.min.device.rows": min_rows}))
        Hyperspace(sess).create_index(sess.read_parquet(str(src)),
                                      DataSkippingIndexConfig(
                                          "sk", ["k", "s", "x", "b", "g"]))
        path = tmp_path / lane / "indexes" / "sk" / "v__=0" / "_hs_sketches"
        blobs.append(path.read_bytes())
    assert blobs[0] == blobs[1]


# -- the compile and launch seam (telemetry/compilation.py) -----------------

def test_card_event_seconds_resolve_without_a_per_call_sync(card,
                                                            monkeypatch):
    from hyperspace_tpu_torch import telemetry

    lanes = torch.randint(-2**31, 2**31 - 1, (2, 1 << 22),
                          dtype=torch.int32, device=card)
    from hyperspace_tpu_torch.telemetry import compilation

    # Without a recorder: no events, the dispatch queued for counting.
    compilation.resolve_pending()
    hash_kernel.hash_lanes_to_buckets(lanes, 200)
    assert [c[0] for c in compilation._pending] == [
        "cuda.hash_lanes_to_buckets"]
    assert compilation._pending[0][1] is None
    before = telemetry.get_registry().counters_dict()
    compilation.resolve_pending()
    after = telemetry.get_registry().counters_dict()
    assert after["device.dispatches"] - before.get(
        "device.dispatches", 0) == 1
    assert after["device.bytes_accessed"] - before.get(
        "device.bytes_accessed", 0) == (1 << 22) * 12
    torch.cuda.synchronize()
    waits = []
    real_sync = torch.cuda.synchronize
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: (waits.append(1),
                                         real_sync(*a, **k))[1])
    real_event_sync = torch.cuda.Event.synchronize
    monkeypatch.setattr(torch.cuda.Event, "synchronize",
                        lambda self: (waits.append(1),
                                      real_event_sync(self))[1])
    qm = telemetry.QueryMetrics("card")
    with telemetry.recording(qm):
        for _ in range(4):
            hash_kernel.hash_lanes_to_buckets(lanes, 200)
    assert waits == [] and len(qm._device_events) == 4
    assert "device.dispatch_s" not in qm.counters
    qm.finish()
    assert waits and qm._device_events == []
    assert qm.counters["device.dispatch_s"] > 0
    roof = qm.roofline
    assert roof["bytes_accessed"] == 4 * (1 << 22) * 12
    assert 0 < roof["device_share"] <= 1


def test_card_device_trace_names_the_hash_kernel(card, tmp_path):
    import json as _json

    from hyperspace_tpu_torch.telemetry import profiler

    lanes = torch.randint(-2**31, 2**31 - 1, (2, 1 << 20),
                          dtype=torch.int32, device=card)
    with profiler.device_trace(str(tmp_path / "cap")):
        hash_kernel.hash_lanes_to_buckets(lanes, 200)
        torch.cuda.synchronize()
    with open(tmp_path / "cap" / profiler.TRACE_FILE) as f:
        kernels = [e["name"] for e in _json.load(f)["traceEvents"]
                   if e.get("cat") == "kernel"]
    assert any("hash_lanes_to_buckets_kernel" in k for k in kernels)


def test_card_failed_nvcc_build_raises(card, tmp_path, monkeypatch):
    from hyperspace_tpu_torch.exceptions import HyperspaceException
    from hyperspace_tpu_torch.ops.cuda import build

    (tmp_path / "broken.cu").write_text(
        "__global__ void k( { }\n")
    monkeypatch.setattr(build, "CSRC_DIR", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "out"))
    monkeypatch.setattr(build, "SOURCES", {"broken": "broken.cu"})
    with pytest.raises(HyperspaceException, match="nvcc failed"):
        build.build_all(["broken"])
    assert not [f for f in os.listdir(tmp_path / "out")
                if f.endswith(".so")]


def test_card_memory_sample_reads_the_allocators_counters(card):
    from hyperspace_tpu_torch.telemetry import memory

    held = torch.empty(1 << 20, dtype=torch.uint8, device="cuda")
    torch.cuda.synchronize()
    sample = memory._stats_sample()
    st = torch.cuda.memory_stats(0)
    assert sample["cuda:0"] == (st["allocated_bytes.all.current"],
                                st["allocated_bytes.all.peak"])
    assert sample["cuda:0"][0] >= held.numel()


@pytest.mark.parametrize("kb", [2, 16])
def test_card_batched_masks_equal_the_cpu_evaluation(card, kb):
    """The batch lane's [K_b, N] masks on the card (every term kind,
    float32/float64/int columns, int and float literals, validity)
    equal the same program evaluated on the CPU, and stay on the
    card."""
    from hyperspace_tpu_torch.parallel import spmd

    rng = np.random.default_rng(kb)
    n = 100_003
    datas = ((rng.integers(-9, 9, n) / 4.0).astype(np.float32),
             rng.integers(-9, 9, n).astype(np.int64),
             rng.random(n), rng.integers(-9, 9, n).astype(np.int32))
    valids = (rng.random(n) > 0.2, None, rng.random(n) > 0.5, None)
    shape = (("cmp", "ge", 0, "f"), ("cmp", "ne", 1, "i"),
             ("cmp", "lt", 2, "f"), ("in", 3, 4), ("cmp", "gt", 3, "f"),
             ("notnull", 2), ("isnull", 1))
    iconst = rng.integers(-9, 9, (kb, 5)).astype(np.int64)
    fconst = rng.random((kb, 3)) * 4 - 2
    want = spmd.batched_predicate_masks(shape, datas, valids, iconst,
                                        fconst)
    got = spmd.batched_predicate_masks(
        shape, tuple(torch.from_numpy(d).to(card) for d in datas),
        tuple(None if v is None else torch.from_numpy(v).to(card)
              for v in valids), iconst, fconst)
    assert got.device.type == "cuda" and got.shape == (kb, n)
    assert torch.equal(got.cpu(), want)


def test_card_concurrent_collect_burst_coalesces(card, tmp_path):
    """A burst of same-shape point queries on a CUDA session goes through
    the scheduler and the batch lane: every result equals its solo run,
    at least one cohort formed, nothing fell back."""
    import threading

    from hyperspace_tpu_torch import (HyperspaceConf, HyperspaceSession,
                                      col, lit, telemetry)
    from hyperspace_tpu_torch.engine import batcher, scheduler

    scheduler.set_scheduler(scheduler.QueryScheduler())
    batcher.set_batcher(batcher.QueryBatcher())
    rng = np.random.default_rng(9)
    n = 1 << 20
    src = tmp_path / "facts"
    src.mkdir()
    pq.write_table(pa.table({
        "k": rng.integers(0, 1000, n).astype(np.int64),
        "g": rng.integers(0, 32, n).astype(np.int64),
        "v": rng.random(n)}), str(src / "part-0.parquet"))
    sess = HyperspaceSession(HyperspaceConf({
        "spark.hyperspace.warehouse.dir": str(tmp_path / "wh"),
        "spark.hyperspace.execution.min.device.rows": "0",
        "spark.hyperspace.serve.batch.window.ms": "200"}))
    facts = sess.read_parquet(str(src))
    frames = [facts.filter(col("g") == lit(i)).select("k", "v")
              for i in range(8)]
    solo = [f.collect().sort_by([("k", "ascending"), ("v", "ascending")])
            for f in frames]
    reg = telemetry.get_registry()
    inv0 = reg.counter("serve.batch.invocations").value
    fb0 = reg.counter("serve.batch.fallbacks").value
    got = [None] * len(frames)

    def run(i):
        got[i] = frames[i].collect()

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(frames))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(120)
    assert not any(th.is_alive() for th in threads)
    for a, b in zip(got, solo):
        assert a.sort_by([("k", "ascending"), ("v", "ascending")]).equals(b)
    assert reg.counter("serve.batch.invocations").value > inv0
    assert reg.counter("serve.batch.fallbacks").value == fb0
    assert scheduler.get_scheduler().admitted_bytes() == 0


def _count_syncs(fn):
    """(fn(), host syncs it made), counted by torch's sync debug mode."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) for w in caught)


def _fusion_lake(tmp_path):
    rng = np.random.default_rng(17)
    n = 1 << 18
    fact, dim = tmp_path / "fact", tmp_path / "dim"
    fact.mkdir()
    dim.mkdir()
    pq.write_table(pa.table({
        "k": rng.integers(0, 1200, n).astype(np.int64),
        "a": pa.array(rng.integers(-50, 50, n).astype(np.int32),
                      mask=rng.random(n) < 0.05),
        "v": rng.standard_normal(n),
        "g": pa.array([f"g{i % 7}" for i in range(n)])}),
        str(fact / "part-0.parquet"))
    pq.write_table(pa.table({
        "k": np.arange(1000, dtype=np.int64),
        "w": pa.array(rng.standard_normal(1000),
                      mask=np.arange(1000) % 9 == 0),
        "name": pa.array([None if i % 13 == 0 else f"n{i % 31}"
                          for i in range(1000)])}), str(dim / "part-0.parquet"))
    return str(fact), str(dim)


def _fusion_session(tmp_path, device, fused):
    from hyperspace_tpu_torch import HyperspaceConf, HyperspaceSession
    return HyperspaceSession(HyperspaceConf({
        "spark.hyperspace.warehouse.dir": str(tmp_path / "wh"),
        "spark.hyperspace.execution.min.device.rows": "0",
        "spark.hyperspace.execution.fusion.enabled":
            "true" if fused else "false"}), device=device)


def _fusion_query(sess, fact, dim, how="inner"):
    """Filter -> Filter -> Project -> BroadcastHashJoin."""
    from hyperspace_tpu_torch import col, lit
    from hyperspace_tpu_torch.plan.expr import CaseWhen

    q = (sess.read_parquet(fact)
         .filter(col("k") > lit(5))
         .filter(col("a") < lit(20))
         .with_column("x", col("v") * lit(2.5) + col("a"))
         .join(sess.read_parquet(dim), on=col("k") == col("k"), how=how))
    if how in ("left_semi", "left_anti"):
        return q.select("k", "x", "g")
    return (q.with_column("y", CaseWhen([(col("w") > lit(0.0),
                                          col("x") * col("w"))], col("x")))
            .select("k", "x", "y", "name", "g"))


def test_card_fused_stage_syncs_at_most_once(card, tmp_path, monkeypatch):
    """A warm fused Filter->Filter->Project->BHJ stage over device-resident
    batches waits on the card at most once (its compaction); the same
    query with fusion off waits at least once per Filter."""
    from hyperspace_tpu_torch.engine import compiler, fusion

    fact, dim = _fusion_lake(tmp_path)
    stage_syncs, filter_syncs = [], []
    run_device = fusion.FusedStageExec._execute_device
    apply_filter = compiler.apply_filter

    def spy_stage(self, batches, preps):
        out, n = _count_syncs(lambda: run_device(self, batches, preps))
        stage_syncs.append((len(fusion._region_nodes(self.root)), n))
        return out

    def spy_filter(batch, expression):
        out, n = _count_syncs(lambda: apply_filter(batch, expression))
        filter_syncs.append(n)
        return out

    monkeypatch.setattr(fusion.FusedStageExec, "_execute_device", spy_stage)
    monkeypatch.setattr(compiler, "apply_filter", spy_filter)
    fused_sess = _fusion_session(tmp_path, card, True)
    _fusion_query(fused_sess, fact, dim).collect()  # warm the caches
    stage_syncs.clear()
    fused = _fusion_query(fused_sess, fact, dim).collect()
    assert stage_syncs and max(n for _ops, n in stage_syncs) <= 1
    assert any(ops >= 4 for ops, _n in stage_syncs), stage_syncs
    assert not filter_syncs

    eager_sess = _fusion_session(tmp_path, card, False)
    _fusion_query(eager_sess, fact, dim).collect()
    filter_syncs.clear()
    eager = _fusion_query(eager_sess, fact, dim).collect()
    assert len(filter_syncs) == 2 and min(filter_syncs) >= 1
    assert sum(filter_syncs) > sum(n for _ops, n in stage_syncs)
    key = [(c, "ascending") for c in fused.column_names]
    assert fused.sort_by(key).equals(eager.sort_by(key))


@pytest.mark.parametrize("how", ["inner", "left_outer", "left_semi",
                                 "left_anti"])
def test_card_fused_equals_unfused_and_cpu(card, tmp_path, how):
    fact, dim = _fusion_lake(tmp_path)
    key = None
    results = []
    for device, fused in ((card, True), (card, False),
                          (torch.device("cpu"), True)):
        table = _fusion_query(_fusion_session(tmp_path, device, fused),
                              fact, dim, how).collect()
        key = [(c, "ascending") for c in table.column_names]
        results.append(table.sort_by(key))
    assert results[0].num_rows > 0
    assert results[0].equals(results[1])
    assert results[0].equals(results[2])


def test_card_advisor_run_once_builds_through_the_hash_kernel(
        card, tmp_path, monkeypatch):
    from hyperspace_tpu_torch import (Hyperspace, HyperspaceConf,
                                      HyperspaceSession, col, telemetry)

    monkeypatch.setattr(builder, "BUILD_MIN_DEVICE_ROWS", 0)
    telemetry.get_recorder().clear()
    rng = np.random.default_rng(11)
    n = 1 << 16
    facts = tmp_path / "facts"
    facts.mkdir()
    pq.write_table(pa.table({
        "k": rng.integers(0, n // 8, n).astype(np.int64),
        "v": rng.random(n),
        "tag": rng.integers(0, 50, n).astype(np.int32)}),
        str(facts / "part-0.parquet"))
    sess = HyperspaceSession(HyperspaceConf({
        "spark.hyperspace.warehouse.dir": str(tmp_path / "wh"),
        "spark.hyperspace.index.num.buckets": "8",
        "spark.hyperspace.advisor.max.builds": "6"}),
        device=card).enable_hyperspace()
    q = sess.read_parquet(str(facts)).filter(col("tag") == 7) \
        .select("k", "v", "tag")
    before = q.collect()
    for _ in range(3):
        q.collect()
    launches = hash_kernel.hash_lanes_to_buckets.launches
    summary = Hyperspace(sess).advisor().run_once()
    assert any(d["action"] == "built" for d in summary["decisions"])
    assert hash_kernel.hash_lanes_to_buckets.launches > launches
    after = q.collect()
    m = sess.last_query_metrics()
    assert any(e.get("action") == "applied" for e in m.events
               if e.get("category") == "rule")
    key = [("v", "ascending")]
    assert after.sort_by(key).equals(before.sort_by(key))


def test_card_mesh_rebucket_ids_equal_plain_version_and_join_equals_cpu(
        card):
    """On a virtual 4-shard mesh of the card, the SPMD join's in-mesh
    re-bucket (a 16-bucket left, an 8-bucket right): each shard's bucket
    ids from the hash kernel equal the plain version's on the same
    lanes, the join launches the kernel once per shard, and its
    left_outer rows equal the same join on a virtual mesh of the CPU."""
    from hyperspace_tpu_torch.parallel import spmd, virtual
    from hyperspace_tpu_torch.parallel.build import distributed_build
    from hyperspace_tpu_torch.parallel.mesh import make_mesh

    rng = np.random.default_rng(13)
    tables = [(pa.table({"k": rng.integers(0, 5000, n).astype(np.int64),
                         "x": rng.standard_normal(n)}), buckets)
              for n, buckets in ((40_000, 16), (20_000, 8))]
    rows = {}
    for dev in (card, torch.device("cpu")):
        with virtual.virtual_devices(4, dev):
            mesh = make_mesh(4)
            lsh, rsh = [spmd.shard_bucket_ordered(*distributed_build(
                columnar.from_arrow(t, device=dev), ["k"], b, mesh), mesh)
                for t, b in tables]
            if dev.type == "cuda":
                for lanes in spmd.routing_lanes(rsh, ["k"]):
                    got = hash_kernel.hash_lanes_to_buckets(lanes, 16)
                    torch.cuda.synchronize()
                    want = hash_kernel.hash_lanes_to_buckets_reference(
                        lanes.cpu(), 16)
                    assert (got.cpu() == want).all()
            before = hash_kernel.hash_lanes_to_buckets.launches
            li, ri = spmd.sharded_join_indices(lsh, rsh, ["k"], ["k"],
                                               how="left_outer")
            launched = hash_kernel.hash_lanes_to_buckets.launches - before
            assert launched == (4 if dev.type == "cuda" else 0)
            li, ri = li.cpu().numpy(), ri.cpu().numpy()
            lx = lsh.batch.column("x").data.cpu().numpy()
            rx = rsh.batch.column("x").data.cpu().numpy()
            rows[dev.type] = sorted(zip(
                lx[li].tolist(),
                [repr(v) for v in np.where(ri >= 0, rx[np.clip(ri, 0, None)],
                                           np.nan).tolist()]))
    assert len(rows["cuda"]) > 40_000
    assert rows["cuda"] == rows["cpu"]


def test_card_routed_join_rebuckets_on_each_slice(card, tmp_path,
                                                  monkeypatch):
    """On a virtual 2 x 2 mesh of the card with replication on, two
    threads run the mismatched join (200 against 64 buckets) through the
    scheduler: the router sends them to the two slices, each re-buckets
    its right side through the hash kernel (2 launches a collect, one
    per shard of its slice, ids equal to the plain version's), the
    segment cache holds both slices' shards under two device tags, and
    the rows equal the same run on a virtual mesh of the CPU."""
    import threading

    from hyperspace_tpu_torch import (Hyperspace, HyperspaceConf,
                                      HyperspaceSession, IndexConfig)
    from hyperspace_tpu_torch.io import segcache
    from hyperspace_tpu_torch.parallel import replica, virtual

    monkeypatch.setattr(builder, "BUILD_MIN_DEVICE_ROWS", 0)
    rng = np.random.default_rng(29)
    src = {}
    for side, n, payload in (("l", 60_000, "id"), ("r", 30_000, "val")):
        src[side] = str(tmp_path / side)
        os.makedirs(src[side])
        pq.write_table(pa.table({
            "key": rng.integers(0, 20_000, n).astype(np.int64),
            payload: (np.arange(n, dtype=np.int64) if payload == "id"
                      else rng.standard_normal(n))}),
            os.path.join(src[side], "p.parquet"))
    rows = {}
    for dev in (card, torch.device("cpu")):
        with virtual.virtual_devices(4, dev):
            replica.reset_router()
            segcache.clear()
            sess = HyperspaceSession(HyperspaceConf({
                "spark.hyperspace.warehouse.dir": str(
                    tmp_path / f"wh-{dev.type}"),
                "spark.hyperspace.index.num.buckets": "200",
                "spark.hyperspace.execution.min.device.rows": "0",
                "spark.hyperspace.broadcast.threshold": "-1",
                "spark.hyperspace.distribution.enabled": "true",
                "spark.hyperspace.distribution.slices": "2"}),
                device=dev.type)
            hs = Hyperspace(sess)
            left = sess.read_parquet(src["l"])
            right = sess.read_parquet(src["r"])
            hs.create_index(left, IndexConfig("lk", ["key"], ["id"]))
            sess.conf.set("spark.hyperspace.index.num.buckets", "64")
            hs.create_index(right, IndexConfig("rk", ["key"], ["val"]))
            sess.enable_hyperspace()
            query = left.select("key", "id").join(
                right.select("key", "val"), on="key")
            seen = []
            real = hash_kernel.hash_lanes_to_buckets

            class Spy:
                """Records each call; `launches` stays the wrapper's."""

                launches = property(
                    lambda self: real.launches,
                    lambda self, n: setattr(real, "launches", n))

                def __call__(self, lanes, num_buckets):
                    out = real(lanes, num_buckets)
                    seen.append((lanes, num_buckets, out))
                    return out

            monkeypatch.setattr(hash_kernel, "hash_lanes_to_buckets", Spy())
            before = real.launches
            results, replicas, errors = [], [], []

            def client():
                try:
                    table, m = query.collect(with_metrics=True)
                    results.append(table)
                    replicas.append(m.replica)
                except Exception as exc:  # pragma: no cover
                    errors.append(exc)

            threads = [threading.Thread(target=client) for _ in range(2)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            monkeypatch.setattr(hash_kernel, "hash_lanes_to_buckets", real)
            assert not errors, errors
            assert sorted(replicas) == [0, 1]
            assert replica.get_router().routed_counts() == {0: 1, 1: 1}
            launched = real.launches - before
            assert launched == (4 if dev.type == "cuda" else 0)
            assert len(seen) == 4
            for lanes, num_buckets, got in seen:
                assert num_buckets == 200
                want = hash_kernel.hash_lanes_to_buckets_reference(
                    lanes.cpu(), num_buckets)
                assert (got.cpu() == want).all()
            tags = segcache.get_cache().replica_residency()
            assert set(tags) == {(0, 1), (2, 3)}, tags
            key = [("key", "ascending"), ("id", "ascending"),
                   ("val", "ascending")]
            rows[dev.type] = [t.sort_by(key) for t in results]
            assert rows[dev.type][0].equals(rows[dev.type][1])
            segcache.clear()
            replica.reset_router()
    assert rows["cuda"][0].num_rows > 60_000
    assert rows["cuda"][0].equals(rows["cpu"][0])
