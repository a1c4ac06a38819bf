"""Bench artifacts and the regression differ of `hyperspace_tpu_torch`
(`telemetry/artifact.py`, `telemetry/diff.py`) against the JAX package,
exact: `validate`, `unwrap` and `migrate` on every committed
`BENCH_*.json` and `MULTICHIP_*.json`, `diff_artifacts` on the committed
round pairs, `diff_trees` on recorded trees, and artifacts written by
either package loading in the other. Also the port's own additions:
the platform and the card's kind and power limit.

Process state: none is changed beyond the registries' monotonic
counters (the digests only read them).
"""

import glob
import json
import os

import pytest
from torch_suites import jax_counters_guard  # noqa: E402,F401
import torch

from hyperspace_tpu.telemetry import artifact as jartifact
from hyperspace_tpu.telemetry import diff as jdiff
from hyperspace_tpu import telemetry as jtelemetry
from hyperspace_tpu_torch import telemetry
from hyperspace_tpu_torch.telemetry import artifact, diff

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMITTED = sorted(os.path.basename(p) for p in
                   glob.glob(os.path.join(REPO, "BENCH_*.json"))
                   + glob.glob(os.path.join(REPO, "MULTICHIP_*.json")))
PAIRS = [("BENCH_TPCDS_r03.json", "BENCH_TPCDS_r04.json"),
         ("BENCH_r07.json", "BENCH_r08.json")]


def _raw(name):
    with open(os.path.join(REPO, name)) as f:
        return json.load(f)


def test_schema_constants_are_the_jax_packages():
    assert artifact.SCHEMA_VERSION == jartifact.SCHEMA_VERSION
    assert artifact.REQUIRED_FIELDS == jartifact.REQUIRED_FIELDS
    assert len(COMMITTED) >= 20


@pytest.mark.parametrize("name", COMMITTED)
def test_validate_unwrap_migrate_equal_jax(name):
    doc = _raw(name)
    assert artifact.unwrap(doc) == jartifact.unwrap(doc)
    assert artifact.validate(doc) == jartifact.validate(doc)
    assert artifact.is_canonical(doc) == jartifact.is_canonical(doc)
    assert artifact.migrate(doc, source=name) == \
        jartifact.migrate(doc, source=name)
    path = os.path.join(REPO, name)
    assert artifact.load(path, migrate_legacy=True) == \
        jartifact.load(path, migrate_legacy=True)


@pytest.mark.parametrize("old,new", PAIRS)
def test_diff_artifacts_equal_jax_on_committed_pairs(old, new):
    docs = {}
    for pkg_name, pkg in (("torch", artifact), ("jax", jartifact)):
        docs[pkg_name] = [pkg.load(os.path.join(REPO, n), migrate_legacy=True)
                          for n in (old, new)]
    got = diff.diff_artifacts(*docs["torch"], old_name=old, new_name=new)
    want = jdiff.diff_artifacts(*docs["jax"], old_name=old, new_name=new)
    assert got.to_dict() == want.to_dict()
    assert got.format_tree() == want.format_tree()
    assert got.queries and got.to_dict()["queries"][0]["buckets"]


def test_legacy_load_refuses_then_migrates(tmp_path):
    path = tmp_path / "BENCH_legacy.json"
    path.write_text(json.dumps({"metric": "m", "value": 1}))
    with pytest.raises(artifact.LegacyArtifactError):
        artifact.load(str(path))
    assert artifact.load(str(path), migrate_legacy=True)["legacy"] is True


def test_migrate_file_and_cli_equal_jax(tmp_path, capsys):
    legacy = {"n": 5, "cmd": "python bench.py", "rc": 0, "tail": "",
              "parsed": {"metric": "m", "value": 1.5, "vs_baseline": 2.0}}
    ours, theirs = tmp_path / "ours.json", tmp_path / "theirs.json"
    for p in (ours, theirs):
        p.write_text(json.dumps(legacy))
    assert artifact._main(["migrate", str(ours)]) == 0
    assert jartifact.migrate_file(str(theirs))
    assert json.loads(ours.read_text()) == json.loads(theirs.read_text())
    assert "migrated" in capsys.readouterr().out
    assert not artifact.migrate_file(str(ours))
    assert artifact._main([]) == 2


def _recorded(pkg, wall, compile_s=0.0, link_s=0.0, dispatch_s=0.0):
    qm = pkg.QueryMetrics(description="q")
    op = qm.start_operator("Scan")
    qm.finish_operator(op, rows_out=100)
    op.wall_s = wall * 0.5
    qm.add_seconds("compile.seconds", compile_s)
    qm.add_seconds("link.h2d_s", link_s)
    qm.add_seconds("device.dispatch_s", dispatch_s)
    qm.finish()
    qm.wall_s = wall
    return json.loads(json.dumps(qm.to_dict(), default=str))


@pytest.mark.parametrize("new_kw", [
    {"wall": 2.0, "compile_s": 1.0},
    {"wall": 1.5, "link_s": 0.4},
    {"wall": 1.2, "dispatch_s": 0.3},
    {"wall": 0.5},
])
def test_diff_trees_equal_jax(new_kw):
    old = _recorded(telemetry, 1.0)
    new = _recorded(telemetry, **new_kw)
    got = diff.diff_trees(old, new, "q").to_dict()
    assert got == jdiff.diff_trees(old, new, "q").to_dict()
    jold = _recorded(jtelemetry, 1.0)
    jnew = _recorded(jtelemetry, **new_kw)
    assert jdiff.diff_trees(jold, jnew, "q").to_dict()["buckets"] == \
        got["buckets"]


def _port_artifact(**kw):
    qm = telemetry.QueryMetrics("q")
    qm.finish()
    return artifact.make_artifact(
        driver="test", metric="wall_s", value=qm.wall_s, unit="s",
        vs_baseline=None, queries={"q": artifact.query_metrics_block(qm)},
        **kw)


def test_port_artifact_loads_in_jax_and_back(tmp_path):
    ours = tmp_path / "ours.json"
    ours.write_text(json.dumps(_port_artifact(device="cpu"), default=str))
    loaded = jartifact.load(str(ours))
    assert jartifact.validate(loaded) == []
    assert loaded["platform"] == "cpu"
    theirs = tmp_path / "theirs.json"
    theirs.write_text(json.dumps(jartifact.make_artifact(
        driver="bench.py", metric="m", value=1.0, unit="s",
        vs_baseline=None), default=str))
    assert artifact.validate(artifact.load(str(theirs))) == []
    # The two packages' process digests carry the same sections.
    doc = artifact.load(str(ours))
    assert set(doc["critical_path"]) == set(loaded["critical_path"])
    assert set(doc["device_cost"]) == set(
        jartifact.device_cost_digest())
    assert set(doc["tenant_cost"]) == set(jartifact.tenant_cost_digest())
    assert doc["tenant_cost"]["exact"] is True
    assert set(doc["transfer"]) == set(jartifact.transfer_digest())
    assert set(doc["queries"]["q"]) == {"metrics", "tree"}
    assert diff.diff_artifacts(doc, doc).to_dict()["queries"][0][
        "delta_s"] == 0.0


def test_platform_is_the_tensors_device(monkeypatch):
    cpu = _port_artifact(device=torch.device("cpu"))
    assert (cpu["platform"], cpu["device_kind"], cpu["power_limit"]) == \
        ("cpu", None, None)
    assert _port_artifact()["platform"] == "cpu"
    # A CUDA device without nvidia-smi: the kind and limit stay None,
    # never made up.
    monkeypatch.setattr("shutil.which", lambda name: None)
    gpu = _port_artifact(device="cuda:0")
    assert (gpu["platform"], gpu["device_kind"], gpu["power_limit"]) == \
        ("gpu", None, None)


def test_card_kind_and_power_limit_from_nvidia_smi(monkeypatch):
    import subprocess

    class Done:
        stdout = "NVIDIA H100 80GB HBM3, 700.00 W\n"

    monkeypatch.setattr("shutil.which", lambda name: "/bin/nvidia-smi")
    calls = []

    def run(cmd, **kw):
        calls.append(cmd)
        return Done()

    monkeypatch.setattr(subprocess, "run", run)
    assert artifact.device_digest("cuda") == {
        "platform": "gpu", "device_kind": "NVIDIA H100 80GB HBM3",
        "power_limit": "700.00 W"}
    assert calls == [["/bin/nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"]]

    def fails(cmd, **kw):
        raise subprocess.CalledProcessError(9, cmd)

    monkeypatch.setattr(subprocess, "run", fails)
    assert artifact.device_digest("cuda")["device_kind"] is None


def test_device_cost_digest_lists_the_seams_entry_points():
    from hyperspace_tpu_torch.ops.cuda import hash_kernel

    hash_kernel.hash_lanes_to_buckets(
        torch.zeros((2, 64), dtype=torch.int32), 8)
    digest = artifact.device_cost_digest()
    assert digest["per_entry_point"]["cuda.hash_lanes_to_buckets"] == {
        "flops": float(20 * 2 * 64), "bytes_accessed": float(64 * 12)}
    assert digest["dispatch_seconds"] > 0
