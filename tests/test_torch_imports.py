"""The port, chip_smoke.py and chip_mutants.py import nothing that the GPU
machine lacks:
no JAX stack, PyYAML, gymnasium, OpenCV, nor the JAX package itself.  An
``ast`` scan of every import, matched on the top-level module name."""

import ast
import glob
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "flax", "optax", "orbax", "yaml", "gymnasium", "cv2", "dreamer_tpu"}
FILES = sorted(glob.glob(os.path.join(ROOT, "dreamer_tpu_torch", "**", "*.py"),
                         recursive=True)) + [os.path.join(ROOT, "chip_smoke.py"),
                                             os.path.join(ROOT, "chip_mutants.py")]


def imported_top_levels(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(
                node.func, "id", None)) in ("__import__", "import_module")
                and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def test_scan_finds_the_package():
    assert len(FILES) > 10
    assert imported_top_levels(os.path.join(ROOT, "dreamer_tpu_torch", "ops",
                                            "gru_cuda.py")) >= {"torch", "dreamer_tpu_torch"}


def test_scan_catches_forbidden_forms(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import jax.numpy as jnp\nfrom dreamer_tpu.config import X\n"
                 "import importlib\nimportlib.import_module('yaml')\n"
                 "import dreamer_tpu_torch\n")
    assert imported_top_levels(str(p)) & FORBIDDEN == {"jax", "dreamer_tpu", "yaml"}


@pytest.mark.parametrize("path", FILES, ids=[os.path.relpath(p, ROOT) for p in FILES])
def test_no_forbidden_import(path):
    assert not imported_top_levels(path) & FORBIDDEN


def test_importing_the_port_loads_none_of_them():
    code = ("import sys, dreamer_tpu_torch, dreamer_tpu_torch.train, dreamer_tpu_torch.bridge,"
            " dreamer_tpu_torch.orchestrator, dreamer_tpu_torch.cli.train;"
            f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {sorted(FORBIDDEN)!r});"
            "print(bad); sys.exit(1 if bad else 0)")
    run = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert run.returncode == 0, run.stdout + run.stderr
