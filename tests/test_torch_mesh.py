"""The port's mesh, virtual device list and distribution policy against
the JAX package's, on the CPU.

The bucket <-> shard arithmetic must equal the JAX functions exactly
(it fixes the on-disk born-sharded layout); the mesh shapes and the
`should_distribute` decision table must be the JAX package's for the
same conf. The JAX side runs on the conftest's 8 virtual CPU devices
(a prefix of them where a test asks for fewer); the port side on
`parallel/virtual`'s CPU shards, restored after every test.
"""

import contextlib

import numpy as np
import pytest
from torch_suites import jax_counters_guard  # noqa: E402,F401
import torch

import jax

from hyperspace_tpu.config import HyperspaceConf as JConf
from hyperspace_tpu.parallel import context as jcontext
from hyperspace_tpu.parallel import mesh as jmesh

torch.set_num_threads(1)

from hyperspace_tpu_torch.config import HyperspaceConf as TConf
from hyperspace_tpu_torch.parallel import context as tcontext
from hyperspace_tpu_torch.parallel import mesh as tmesh
from hyperspace_tpu_torch.parallel import virtual

BUCKET_COUNTS = (1, 2, 3, 5, 7, 8, 16, 63, 64, 200, 1000, 4096)


@pytest.fixture(autouse=True)
def _no_virtual_mesh_left():
    virtual.reset()
    yield
    virtual.reset()


@pytest.mark.parametrize("num_buckets", BUCKET_COUNTS)
def test_bucket_arithmetic_equals_jax(num_buckets):
    rng = np.random.default_rng(num_buckets)
    buckets = np.arange(num_buckets, dtype=np.int64)
    for n in range(1, 17):
        ranges = tmesh.bucket_ranges(num_buckets, n)
        assert ranges == jmesh.bucket_ranges(num_buckets, n)
        owners = tmesh.bucket_owner(buckets, num_buckets, n)
        np.testing.assert_array_equal(
            owners, jmesh.bucket_owner(buckets, num_buckets, n))
        # The tensor form the build routes with is the same map.
        np.testing.assert_array_equal(
            tmesh.bucket_owner(torch.from_numpy(buckets), num_buckets,
                               n).numpy(), owners)
        for lo, hi in ranges:
            assert (owners[lo:hi] == ranges.index((lo, hi))).all() \
                or lo == hi
        lengths = rng.integers(0, 50, num_buckets)
        assert (tmesh.shard_row_segments(lengths, n)
                == jmesh.shard_row_segments(lengths, n))
        for slices in range(1, n + 1):
            if n % slices == 0:
                assert (tmesh.slice_bucket_ranges(num_buckets, slices,
                                                  n // slices)
                        == jmesh.slice_bucket_ranges(num_buckets, slices,
                                                     n // slices))
        for shard in range(n):
            assert (tmesh.slice_of_shard(shard, n)
                    == jmesh.slice_of_shard(shard, n))


@pytest.mark.parametrize("dcn", [None, 2, 4])
def test_mesh_shapes_equal_jax(dcn):
    virtual.ensure_devices(8, device="cpu")
    tm = tmesh.make_mesh(8, dcn_size=dcn)
    jm = jmesh.make_mesh(8, dcn_size=dcn)
    assert tm.shape == dict(jm.shape)
    assert tmesh.row_axes(tm) == jmesh.row_axes(jm)
    assert tmesh.total_shards(tm) == jmesh.total_shards(jm) == 8
    assert tmesh.dcn_size(tm) == jmesh.dcn_size(jm)
    assert tmesh.ici_size(tm) == jmesh.ici_size(jm)
    assert tmesh.mesh_device_tag(tm) == jmesh.mesh_device_tag(jm)
    assert tmesh.mesh_device_list(tm) == [torch.device("cpu")] * 8
    assert tm.virtual
    for idx in range(tmesh.dcn_size(tm)):
        tsub = tmesh.slice_submesh(tm, idx)
        jsub = jmesh.slice_submesh(jm, idx)
        assert tsub.shape == dict(jsub.shape)
        # A slice keeps its shards' ordinals in the full mesh: the JAX
        # package's device ids on its virtual CPU mesh.
        assert tmesh.mesh_device_tag(tsub) == jmesh.mesh_device_tag(jsub)
        n_ici = tmesh.ici_size(tm)
        assert tmesh.mesh_device_tag(tsub) == tuple(
            range(idx * n_ici, (idx + 1) * n_ici))
    with pytest.raises(ValueError):
        tmesh.slice_submesh(tm, tmesh.dcn_size(tm))
    with pytest.raises(ValueError):
        tmesh.make_mesh(9)
    with pytest.raises(ValueError):
        tmesh.make_mesh(8, dcn_size=3)


def test_slice_tags_give_disjoint_dispatch_locks():
    """On a 2 x 4 mesh the two slices' tags are disjoint (the JAX
    package's device ids), so a query holding slice 0's dispatch locks
    never blocks one on slice 1, while the full mesh takes the locks of
    both; the flat mesh keeps the tag it always had."""
    import threading

    from hyperspace_tpu_torch.parallel import spmd

    virtual.ensure_devices(8, device="cpu")
    full = tmesh.make_mesh(8, dcn_size=2)
    s0, s1 = tmesh.slice_submesh(full, 0), tmesh.slice_submesh(full, 1)
    assert not set(tmesh.mesh_device_tag(s0)) & set(
        tmesh.mesh_device_tag(s1))
    assert tmesh.mesh_device_tag(tmesh.make_mesh(8)) == tuple(range(8))
    assert tmesh.mesh_device_tag(full) == tuple(range(8))

    waiting = []

    def try_guard(mesh):
        """True when another thread takes `mesh`'s locks at once."""
        done = threading.Event()

        def body():
            with spmd.dispatch_guard(mesh):
                done.set()

        t = threading.Thread(target=body, daemon=True)
        t.start()
        waiting.append(t)
        return done.wait(0.5)

    with spmd.dispatch_guard(s0):
        assert try_guard(s1)
        assert not try_guard(full)
        assert not try_guard(s0)
    for t in waiting:
        t.join(5)
        assert not t.is_alive()
    assert try_guard(full)


def test_assemble_sharded_rows_is_the_list():
    virtual.ensure_devices(4, device="cpu")
    mesh = tmesh.make_mesh(4)
    parts = [torch.arange(3) + 3 * s for s in range(4)]
    assert tmesh.assemble_sharded_rows(mesh, parts) == parts
    assert tmesh.device_of_shard(mesh, 2) == torch.device("cpu")
    with pytest.raises(ValueError):
        tmesh.assemble_sharded_rows(mesh, parts[:3])


MODES = ("auto", "true", "false")
ROWS = (None, 0, 4095, 4096, 1_000_000)


@contextlib.contextmanager
def _jax_sees(devices):
    """The JAX package's policy over the first `devices` of the
    conftest's virtual CPU devices (it reads `jax.devices()`)."""
    real = jax.devices
    visible = real()[:devices]
    jax.devices = lambda *a, **k: list(visible)
    try:
        yield
    finally:
        jax.devices = real


def _jax_decision(conf, rows, host, devices):
    with _jax_sees(devices):
        return jcontext.should_distribute(conf, rows, host_batch=host)


def _shape(mesh):
    return None if mesh is None else dict(mesh.shape)


@pytest.mark.parametrize("devices", [1, 2, 8])
@pytest.mark.parametrize("mode", MODES)
def test_should_distribute_table_equals_jax(mode, devices):
    """mode x rows x host lane x visible devices, with the flat and the
    2-slice topology knob, min.rows at its default and lowered."""
    virtual.ensure_devices(devices, device="cpu")
    seen = 0
    for slices in ("1", "2"):
        for min_rows in (None, "10"):
            settings = {"spark.hyperspace.distribution.enabled": mode,
                        "spark.hyperspace.distribution.slices": slices}
            if min_rows is not None:
                settings["spark.hyperspace.distribution.min.rows"] = \
                    min_rows
            jconf = JConf(dict(settings))
            tconf = TConf(dict(settings, **{
                "spark.hyperspace.device": "cpu"}))
            assert tcontext.topology(tconf) == _jax_topology(jconf,
                                                              devices)
            for rows in ROWS:
                for host in (False, True):
                    want = _jax_decision(jconf, rows, host, devices)
                    got = tcontext.should_distribute(tconf, rows,
                                                     host_batch=host)
                    assert _shape(got) == _shape(want), \
                        (settings, rows, host)
                    seen += want is not None
    assert (seen > 0) == (devices > 1 and mode != "false")


def _jax_topology(conf, devices):
    with _jax_sees(devices):
        return jcontext.topology(conf)


def test_replica_scope_pins_a_slice_like_jax():
    virtual.ensure_devices(8, device="cpu")
    settings = {"spark.hyperspace.distribution.enabled": "true",
                "spark.hyperspace.distribution.slices": "2"}
    tconf = TConf(dict(settings, **{"spark.hyperspace.device": "cpu"}))
    jconf = JConf(dict(settings))
    assert tcontext.active_replica() is None
    with tcontext.replica_scope(1), jcontext.replica_scope(1):
        assert tcontext.active_replica() == jcontext.active_replica() == 1
        tm = tcontext.distribution_mesh(tconf)
        jm = jcontext.distribution_mesh(jconf)
        assert tm.shape == dict(jm.shape) == {"shard": 4}
        assert tcontext.mesh_size(tm) == jcontext.mesh_size(jm) == 4
    with tcontext.replica_scope(None):
        assert tcontext.active_replica() is None
    assert tcontext.active_replica() is None


def test_ensure_devices_and_reset_leave_one_device():
    """The default is one device (the CPU here), on which nothing
    distributes; `reset` and the context manager put it back."""
    conf = TConf({"spark.hyperspace.distribution.enabled": "true",
                  "spark.hyperspace.device": "cpu"})
    assert virtual.devices() == [torch.device("cpu")]
    assert not virtual.is_virtual()
    assert tcontext.topology(conf) is None
    assert virtual.ensure_devices(8) == [torch.device("cpu")] * 8
    assert tcontext.topology(conf) == (1, 8)
    virtual.reset()
    assert virtual.devices() == [torch.device("cpu")]
    assert tcontext.should_distribute(conf, 10**6) is None
    with virtual.virtual_devices(4, device="cpu"):
        assert len(virtual.devices()) == 4
        with virtual.virtual_devices(2, device="cpu"):
            assert len(virtual.devices()) == 2
        assert len(virtual.devices()) == 4
    assert not virtual.is_virtual()
    assert tcontext.topology(conf) is None
    with pytest.raises(ValueError):
        virtual.ensure_devices(0)


def test_a_cuda_session_without_a_card_sees_no_mesh():
    """Auto mode on a CUDA-configured session counts the cards; with
    none present there is no mesh (the policy never guesses)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    conf = TConf({"spark.hyperspace.distribution.enabled": "true"})
    assert tcontext.topology(conf) is None


def test_distribution_conf_keys_equal_jax():
    from hyperspace_tpu import constants as jconst
    from hyperspace_tpu_torch import constants as tconst

    names = [n for n in dir(jconst) if n.startswith("DISTRIBUTION_")]
    assert len(names) >= 17
    for name in names:
        assert getattr(tconst, name) == getattr(jconst, name), name
    settings = {"spark.hyperspace.distribution.dcn.size": "4",
                "spark.hyperspace.distribution.capacity.factor": "3.5",
                "spark.hyperspace.distribution.dictionary.max.entries": "7",
                "spark.hyperspace.distribution.replication.hot.fraction":
                    "0.25"}
    for conf_settings in ({}, settings):
        j, t = JConf(dict(conf_settings)), TConf(dict(conf_settings))
        for prop in ("distribution", "distribution_min_rows",
                     "distribution_spmd", "distribution_slices",
                     "distribution_replication",
                     "distribution_replication_min_slices",
                     "distribution_replication_hot_fraction",
                     "distribution_capacity_factor",
                     "distribution_dict_max_entries"):
            assert getattr(t, prop) == getattr(j, prop), prop
