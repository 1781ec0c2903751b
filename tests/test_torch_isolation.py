"""The port stands alone: no JAX and no reference package at run time.

``repro_torch`` and every submodule must import with ``jax`` blocked, and
no source file of the port (nor ``chip_smoke.py`` or
``tools/peer_smoke.py``) may name jax or import the reference package
``repro``; ``tools/peer_smoke.py`` also loads with both blocked. The training subpackages import with
both ``jax`` and ``repro`` blocked, and the port's training example names
neither.
"""

import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

BLOCKED_IMPORT = """
import importlib, pkgutil, sys
sys.modules["jax"] = None
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m, mod in sys.modules.items() if mod is not None and (
    m == "repro" or m.startswith("repro.") or m.split(".")[0] == "jax"))
assert not bad, bad
print(len(names))
"""


def test_imports_with_jax_blocked():
    out = subprocess.run(
        [sys.executable, "-c", BLOCKED_IMPORT], capture_output=True,
        text=True, cwd=ROOT, timeout=120,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 20     # every module was visited


KERNEL_MODULES = sorted(
    f"repro_torch.kernels.{p.parent.name}.{p.stem}"
    for p in (PORT / "kernels").glob("*/*.py") if p.stem != "__init__")


@pytest.mark.parametrize("name", KERNEL_MODULES)
def test_a_kernel_module_imports_first(name):
    """Each kernel module imports as a caller's first import, in a fresh
    interpreter: no import cycle through ``repro_torch.comm``."""
    out = subprocess.run(
        [sys.executable, "-c", f"import {name}"], capture_output=True,
        text=True, cwd=ROOT, timeout=120,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr


def port_files():
    files = sorted(PORT.rglob("*.py")) + sorted(PORT.rglob("*.cu"))
    return files + [ROOT / "chip_smoke.py", ROOT / "tools" / "peer_smoke.py"]


def test_no_file_names_jax_or_imports_the_reference():
    names_jax = re.compile(r"\bjax\b", re.IGNORECASE)
    imports_ref = re.compile(r"^\s*(from|import)\s+repro(\.|\s|$)",
                             re.MULTILINE)
    files = port_files()
    assert len(files) > 20
    for path in files:
        text = path.read_text()
        assert not names_jax.search(text), path
        assert not imports_ref.search(text), path


TRAINING_IMPORT = """
import sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import importlib
mod = importlib.import_module("repro_torch." + sys.argv[1])
bad = sorted(m for m, mod in sys.modules.items() if mod is not None and (
    m == "repro" or m.startswith("repro.") or m.split(".")[0] == "jax"))
assert not bad, bad
print(mod.__name__)
"""


@pytest.mark.parametrize("name", ["optim", "data", "training", "checkpoint",
                                  "runtime", "launch.train", "tree",
                                  "launch.mesh", "models.pspec",
                                  "models.moe_dist", "training.sharding",
                                  "launch.specs", "launch.roofline",
                                  "launch.cost", "launch.dryrun"])
def test_training_subpackages_import_with_jax_and_repro_blocked(name):
    out = subprocess.run(
        [sys.executable, "-c", TRAINING_IMPORT, name], capture_output=True,
        text=True, cwd=ROOT, timeout=120,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-1] == f"repro_torch.{name}"


def test_training_example_names_no_jax():
    text = (ROOT / "examples_torch" / "train_smollm.py").read_text()
    assert not re.search(r"\bjax\b", text, re.IGNORECASE)
    assert not re.search(r"^\s*(from|import)\s+repro(\.|\s|$)", text,
                         re.MULTILINE)


@pytest.mark.parametrize("name", ["quickstart", "jacobi_multipath",
                                  "serve_batched"])
def test_examples_import_with_jax_and_repro_blocked(name):
    """Each of the port's examples names no jax and imports nothing of the
    reference package: loaded (not run) with both blocked."""
    path = ROOT / "examples_torch" / f"{name}.py"
    text = path.read_text()
    assert not re.search(r"\bjax\b", text, re.IGNORECASE)
    code = f"""
import importlib.util, sys
sys.modules["jax"] = None
sys.modules["repro"] = None
spec = importlib.util.spec_from_file_location("ex", {str(path)!r})
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
bad = sorted(m for m, x in sys.modules.items() if x is not None and (
    m == "repro" or m.startswith("repro.") or m.split(".")[0] == "jax"))
assert not bad, bad
print(callable(mod.main))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=120,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-1] == "True"


def test_peer_smoke_loads_with_jax_and_repro_blocked():
    """``tools/peer_smoke.py`` names no jax and imports nothing of the
    reference: loaded (not run) with both blocked."""
    path = ROOT / "tools" / "peer_smoke.py"
    code = f"""
import importlib.util, sys
sys.modules["jax"] = None
sys.modules["repro"] = None
spec = importlib.util.spec_from_file_location("peer", {str(path)!r})
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
import repro_torch.comm, repro_torch.core.halo
bad = sorted(m for m, x in sys.modules.items() if x is not None and (
    m == "repro" or m.startswith("repro.") or m.split(".")[0] == "jax"))
assert not bad, bad
print(callable(mod.main))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=120,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-1] == "True"
