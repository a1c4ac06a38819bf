"""A CPU rehearsal of `chip_smoke.py`'s `mesh` phase.

The phase runs on the card after every other phase; here it runs on a
virtual 4-shard mesh of the CPU at 65,536 rows, with every one of its
checks: the born-sharded builds on the flat and the 2 x 2 mesh byte-equal
to the single-device build, the layout record and the log entry's
`shardLayout`, the filters and the group aggregate against numpy and
against distribution off, the `mesh-distribution` trigger, and the SPMD
joins (B re-bucketed between shards, left_outer, A, left_semi, a string
key, A on the 2 x 2 mesh) against numpy and against
`distribution.spmd.enabled=false`, and the replica block (8 clients on
the 2 x 2 topology routed to its two slices, each result equal to its
serial run; the residency per slice, a committed refresh sweeping both,
a cold-range pin). (Its
kernel-launch check applies on a card only: on the CPU the hash wrapper
runs its plain version and counts no launch.)
"""

import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

from hyperspace_tpu_torch import telemetry  # noqa: E402
from hyperspace_tpu_torch.parallel import virtual  # noqa: E402

torch.set_num_threads(1)

EXECS = tuple(f"mesh.{k}.execs" for k in ("build", "filter", "aggregate"))


def test_phase_mesh_passes_on_the_cpu(tmp_path):
    reg = telemetry.get_registry()
    # The phase holds that nothing distributed before it in ITS run; in
    # a test worker other files may have driven the mesh already.
    saved = {name: reg.counter(name).value for name in EXECS}
    for name in EXECS:
        reg.counter(name).set(0)
    try:
        out = chip_smoke.phase_mesh(str(tmp_path), torch.device("cpu"),
                                    n_rows=65536)
    finally:
        for name, value in saved.items():
            reg.counter(name).set(value + reg.counter(name).value)
    assert not virtual.is_virtual()
    assert out["shards"] == 4 and out["virtual"] and out["device_count"] == 0
    # The flat and 2 x 2 builds of the mesh index, then the SPMD joins'
    # right indexes (64 and 200 buckets flat, 200 on the 2 x 2 mesh) and
    # the string join's two sides, then the replica block's right index
    # and its refresh.
    assert out["execs"]["build"] == 2 + 5 + 2
    assert out["execs"]["filter"] >= 2 and out["execs"]["aggregate"] >= 1
    for tag in ("flat", "grid"):
        build = out["build"][tag]
        assert sum(build["shard_rows"]) == 65536
        assert build["files"] == 200 and build["launches"] == 0
        assert build["routed_bytes"] > 0
    assert out["build"]["grid"]["routed_bytes"] >= \
        out["build"]["flat"]["routed_bytes"]
    assert out["filter"]["range"]["rows"] == 65536
    assert out["aggregate"]["groups"] == 100
    assert out["card"] == "cpu"
    spmd = out["spmd"]
    assert set(spmd["joins"]) == {"A", "B", "left_outer", "left_semi",
                                  "string", "A_grid"}
    assert all(j["lane"] == "spmd" for j in spmd["joins"].values())
    assert spmd["repartition_bytes"]["ici"] > 0
    assert spmd["kernel"]["max_abs_err"] == 0
    assert len(spmd["kernel"]["shapes"]) == 4
    rep = out["replica"]
    for tag in ("warm_up", "timed"):
        assert sum(rep[tag]["routed"]) == 64 and min(rep[tag]["routed"]) > 0
    assert rep["replication_off"]["routed"] == [0, 0]
    assert rep["residency"] == {"0,1": 2, "2,3": 2}
    assert set(rep["reads_after_commit"]) == {0, 1}
    assert rep["cold_pin"]["routed"] == rep["cold_pin"]["home"]


def test_phase_mesh_refuses_a_run_that_distributed_before_it(tmp_path):
    reg = telemetry.get_registry()
    saved = reg.counter("mesh.filter.execs").value
    reg.counter("mesh.filter.execs").set(max(saved, 1))
    try:
        try:
            chip_smoke.phase_mesh(str(tmp_path), torch.device("cpu"),
                                  n_rows=4096)
        except SystemExit as exc:
            assert exc.code == 1
        else:
            raise AssertionError("phase_mesh did not refuse the run")
    finally:
        reg.counter("mesh.filter.execs").set(saved)
    assert not virtual.is_virtual()
