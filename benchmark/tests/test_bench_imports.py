"""No run imports JAX or the JAX package, the reference imports nothing of
the program, and a run without a card prints no result."""

import ast
import glob
import json
import os
import subprocess
import sys

from benchmark import harness
from benchmark.tests.cells import ROOT

BENCH_DIR = os.path.join(ROOT, "benchmark")


def _top_imports(path):
    tree = ast.parse(open(path).read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            out.add(node.module.split(".")[0])
    return out


def test_the_check_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "hyperspace_tpu_torch_fake", object())
    assert harness.forbidden_modules() == [] or \
        "hyperspace_tpu_torch_fake" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert "jax" in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "hyperspace_tpu.ops", object())
    assert "hyperspace_tpu" in harness.forbidden_modules()


def test_no_benchmark_file_imports_jax_or_the_jax_package():
    for path in glob.glob(os.path.join(BENCH_DIR, "**", "*.py"), recursive=True):
        assert not _top_imports(path) & set(harness.FORBIDDEN_MODULES), path


def test_the_reference_imports_nothing_of_the_program():
    files = glob.glob(os.path.join(BENCH_DIR, "reference", "*.py"))
    for path in files:
        assert "hyperspace_tpu_torch" not in _top_imports(path), path
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import benchmark.reference.compare, benchmark.reference.tpch\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('hyperspace_tpu_torch', 'hyperspace_tpu', 'jax', 'torch')))" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]"


def test_a_run_of_the_program_loads_no_jax():
    """The modules a run imports, in a fresh process, hold no JAX."""
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from benchmark import harness, spec, control\n"
            "from benchmark.tests import cells\n"
            "spec.load_family(spec.find_cell(%r, 'tpch-sf1.unindexed-streams').config)\n"
            "import hyperspace_tpu_torch, torch\n"
            "print(harness.forbidden_modules())" % (ROOT, ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True,
                         env={**os.environ, "USE_FLAX": "0"})
    assert out.stdout.strip() == "[]"


def test_without_a_card_the_run_prints_no_result():
    out = subprocess.run(
        [sys.executable, os.path.join(BENCH_DIR, "run.py"), "--workload",
         "tpch-sf1.unindexed-streams", "--seed", str(2 ** 31 + 5),
         "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_the_result_keys():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    assert bench["command"] == ["python3", "benchmark/run.py"]
