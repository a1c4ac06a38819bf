"""`hyperspace_tpu_torch` stands alone: no JAX, no `hyperspace_tpu`.

The port imports torch and never jax, and nothing of the JAX package —
not even a module of it that has no JAX in it. Its entry points run on the
CUDA card unless the caller asks for the CPU, and raise where there is no
card.
"""

import ast
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(REPO, "hyperspace_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "hyperspace_tpu")


def _package_files():
    for root, _dirs, files in os.walk(PACKAGE):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(root, name)


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def _imported_modules(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", None) == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def test_no_module_imports_jax_or_the_jax_package():
    files = list(_package_files())
    assert len(files) > 20
    # The native host library's loader is covered like every module.
    assert os.path.join(PACKAGE, "native", "__init__.py") in files
    offenders = [(os.path.relpath(p, REPO), m) for p in files
                 for m in _imported_modules(p) if _forbidden(m)]
    assert offenders == []


SERVING_MODULES = ("engine/scheduler.py", "engine/batcher.py",
                   "engine/ingest.py", "utils/faults.py",
                   "parallel/spmd.py")


def test_serving_modules_stand_alone():
    """The serving plane's modules are the package's own, and so is the
    chaos harness `chip_smoke.py` loads on the machine without JAX; the
    port's `parallel/spmd.py` exports the batched predicate and the
    born-sharded SPMD execution, each name defined there."""
    files = set(_package_files())
    for rel in SERVING_MODULES:
        path = os.path.join(PACKAGE, *rel.split("/"))
        assert path in files, rel
        assert not [m for m in _imported_modules(path) if _forbidden(m)]
    chaos = os.path.join(REPO, "tests", "torch_chaos.py")
    assert not [m for m in _imported_modules(chaos) if _forbidden(m)]
    from hyperspace_tpu_torch.parallel import spmd
    assert "batched_predicate_masks" in spmd.__all__
    assert {"ShardedBatch", "read_sharded", "sharded_join_indices",
            "sharded_semi_anti_indices", "repartition_sharded",
            "sharded_filter", "sharded_group_aggregate"} <= set(spmd.__all__)
    assert all(hasattr(spmd, name) for name in spmd.__all__)


FUSION_AND_ADVISOR_MODULES = ("engine/fusion.py", "advisor/__init__.py",
                              "advisor/miner.py", "advisor/whatif.py",
                              "advisor/executor.py")


def test_fusion_and_advisor_modules_stand_alone():
    """Whole-stage fusion and the advisor are the package's own modules:
    they import neither JAX nor the JAX package, and a fresh process
    importing them loads neither."""
    files = set(_package_files())
    for rel in FUSION_AND_ADVISOR_MODULES:
        path = os.path.join(PACKAGE, *rel.split("/"))
        assert path in files, rel
        assert not [m for m in _imported_modules(path) if _forbidden(m)]
    code = ("import sys\n"
            "import hyperspace_tpu_torch.engine.fusion\n"
            "import hyperspace_tpu_torch.advisor\n"
            "print(sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', "
            "'hyperspace_tpu')))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


DISTRIBUTION_MODULES = ("parallel/__init__.py", "parallel/mesh.py",
                        "parallel/virtual.py", "parallel/context.py",
                        "parallel/build.py", "parallel/scan.py",
                        "parallel/aggregate.py")


def test_distribution_modules_and_chip_smoke_stand_alone():
    """The mesh, the virtual device list, the policy, the sharded build,
    filter and aggregate, and `chip_smoke.py` (which drives them on the
    card, where there is no JAX) import neither JAX nor the JAX package,
    and a fresh process importing them loads neither. None of them
    reaches for `torch.distributed`: the mesh is one controller."""
    files = set(_package_files())
    smoke = os.path.join(REPO, "chip_smoke.py")
    for path in [os.path.join(PACKAGE, *rel.split("/"))
                 for rel in DISTRIBUTION_MODULES] + [smoke]:
        assert path in files or path == smoke, path
        modules = list(_imported_modules(path))
        assert not [m for m in modules if _forbidden(m)], path
        assert not [m for m in modules
                    if m.startswith("torch.distributed")], path
    code = ("import sys\n"
            "import hyperspace_tpu_torch.parallel.aggregate\n"
            "import hyperspace_tpu_torch.parallel.build\n"
            "import hyperspace_tpu_torch.parallel.context\n"
            "import hyperspace_tpu_torch.parallel.virtual\n"
            "import chip_smoke\n"
            "print(sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', "
            "'hyperspace_tpu')))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_fresh_import_loads_neither_jax_nor_the_jax_package():
    modules = sorted(
        os.path.relpath(p, REPO)[:-3].replace(os.sep, ".")
        .removesuffix(".__init__") for p in _package_files())
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', "
        "'hyperspace_tpu'))\n"
        "print(len(bad)); print(bad)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines()[0] == "0", out.stdout


def test_native_library_is_the_ports_own_copy():
    """The port builds and loads its own copy of the native host library
    (`hyperspace_tpu_torch/native/`, built into `hyperspace_tpu_torch/
    _build/`): no module of the port loads `hyperspace_tpu.native` or its
    shared library."""
    assert os.path.exists(os.path.join(PACKAGE, "native",
                                       "hyperspace_host.cpp"))
    code = (
        "import sys\n"
        "from hyperspace_tpu_torch import native\n"
        "from hyperspace_tpu_torch.io import builder, columnar\n"
        "import numpy as np\n"
        "lib = native.get_lib()\n"
        "columnar._string_hash64(np.array(['v%d' % i for i in range(99)]))\n"
        "with open('/proc/self/maps') as f:\n"
        "    maps = f.read()\n"
        "print(lib is not None)\n"
        "print(native.library_path() in maps)\n"
        "print(sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] == 'hyperspace_tpu'))\n"
        "print(sorted({line.split()[-1] for line in maps.splitlines()\n"
        "              if 'hyperspace_host' in line}))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    loaded, mapped, modules, libraries = out.stdout.splitlines()
    assert loaded == "True" and mapped == "True"
    assert modules == "[]"
    for path in ast.literal_eval(libraries):
        assert os.path.dirname(path) == os.path.join(PACKAGE, "_build")


def test_default_device_is_cuda_and_raises_without_it():
    from hyperspace_tpu_torch._torch_config import resolve_device
    from hyperspace_tpu_torch.exceptions import HyperspaceException

    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is valid")
    with pytest.raises(HyperspaceException):
        resolve_device(None)
    with pytest.raises(HyperspaceException):
        resolve_device("cuda")


def test_session_without_cuda_raises_unless_cpu_is_asked(tmp_path):
    import hyperspace_tpu_torch as ths
    from hyperspace_tpu_torch.exceptions import HyperspaceException

    conf = {"spark.hyperspace.warehouse.dir": str(tmp_path)}
    sess = ths.HyperspaceSession(ths.HyperspaceConf(conf), device="cpu")
    assert sess.device == torch.device("cpu")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is valid")
    with pytest.raises(HyperspaceException):
        ths.HyperspaceSession(ths.HyperspaceConf(conf))


def test_kernel_wrapper_never_falls_back_on_a_non_cpu_tensor():
    """A tensor on a device other than the CPU or CUDA is refused, not
    quietly hashed by the plain version."""
    from hyperspace_tpu_torch.exceptions import HyperspaceException
    from hyperspace_tpu_torch.ops.cuda import hash_kernel

    lanes = torch.zeros((1, 4), dtype=torch.int32, device="meta")
    with pytest.raises(HyperspaceException):
        hash_kernel.hash_lanes_to_buckets(lanes, 8)


TELEMETRY = os.path.join(PACKAGE, "telemetry")
JAX_TELEMETRY = os.path.join(REPO, "hyperspace_tpu", "telemetry")


def test_every_telemetry_module_of_the_jax_package_is_ported():
    def modules(path):
        return sorted(f for f in os.listdir(path) if f.endswith(".py"))

    assert modules(TELEMETRY) == modules(JAX_TELEMETRY)


@pytest.mark.parametrize("module", sorted(
    f for f in os.listdir(TELEMETRY) if f.endswith(".py")))
def test_telemetry_module_imports_neither_jax_nor_the_jax_package(module):
    path = os.path.join(TELEMETRY, module)
    assert [m for m in _imported_modules(path) if _forbidden(m)] == []
    with open(path, encoding="utf-8") as f:
        assert "jax.profiler" not in f.read()
