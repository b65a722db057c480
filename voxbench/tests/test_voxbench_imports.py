"""No module of the benchmark imports JAX or the JAX package, compared by
whole top-level names (``cpuvox_tpu_torch`` begins with ``cpuvox_tpu``),
and the reference imports nothing of the program."""
import ast
import os
import subprocess
import sys

from conftest import ROOT
from voxbench import harness

VOXBENCH = os.path.join(ROOT, "voxbench")
BANNED = {"jax", "jaxlib", "flax", "cpuvox_tpu"}
# the reference and what it reads: the frozen generator and path
NO_PROGRAM = ["reference", "worldgen", "generators", "path.py", "traffic.py",
              "stats.py", "control.py"]


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _sources(sub=""):
    base = os.path.join(VOXBENCH, sub)
    if base.endswith(".py"):
        yield base
        return
    for d, dirs, files in os.walk(base):
        dirs[:] = [x for x in dirs if x != "__pycache__"]
        yield from (os.path.join(d, f) for f in files if f.endswith(".py"))


def test_no_module_imports_jax_or_the_jax_package():
    for src in _sources():
        for name in _imports(src):
            assert name.split(".")[0] not in BANNED, (src, name)


def test_the_reference_imports_nothing_of_the_program():
    for sub in NO_PROGRAM:
        for src in _sources(sub):
            for name in _imports(src):
                assert name.split(".")[0] != "cpuvox_tpu_torch", (src, name)
    code = ("import sys; sys.path.insert(0, %r); "
            "import voxbench.reference.check, voxbench.reference.frame, "
            "voxbench.control, voxbench.traffic, voxbench.worldgen.cache; "
            "import voxbench.generators.heightmap_world, "
            "voxbench.generators.layered_world; "
            "bad = sorted({m.split('.')[0] for m in sys.modules} & "
            "{'cpuvox_tpu_torch', 'cpuvox_tpu', 'jax', 'torch'}); "
            "print(bad); sys.exit(1 if bad else 0)" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_the_run_check_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "cpuvox_tpu_torch_fake.x", object())
    assert "cpuvox_tpu" not in harness.banned_modules()
    monkeypatch.setitem(sys.modules, "cpuvox_tpu.render", object())
    assert "cpuvox_tpu" in harness.banned_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", object())
    assert {"cpuvox_tpu", "jaxlib"} <= set(harness.banned_modules())


def test_the_harness_loads_no_jax():
    code = ("import sys; sys.path.insert(0, %r); "
            "import voxbench.harness, voxbench.program, cpuvox_tpu_torch.render.frame; "
            "from voxbench.harness import banned_modules; "
            "print(banned_modules()); sys.exit(1 if banned_modules() else 0)" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
