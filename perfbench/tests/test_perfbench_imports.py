"""Nothing the benchmark runs loads JAX or the JAX package; the reference
imports nothing of the program. Module names are compared whole by their
top-level name: stan_tpu_torch is the port, stan_tpu the JAX package."""

import ast
import pathlib
import subprocess
import sys

from perfbench import harness

PKG = pathlib.Path(harness.__file__).resolve().parent


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_top_level_names_compared_whole():
    names = ["stan_tpu_torch", "stan_tpu_torch.fem.stencil", "jaxtyping",
             "numpy", "stan_tpu.fem", "jax.numpy", "jaxlib", "flax.linen"]
    assert harness.forbidden_modules(names) == ["flax", "jax", "jaxlib",
                                                "stan_tpu"]
    assert harness.forbidden_modules(["stan_tpu_torch.infer"]) == []


def test_no_source_imports_jax_or_the_jax_package():
    for path in PKG.rglob("*.py"):
        assert harness.forbidden_modules(_imports(path)) == [], path


def test_reference_imports_nothing_of_the_program():
    for path in (PKG / "reference").rglob("*.py"):
        tops = {n.split(".")[0] for n in _imports(path)}
        assert "stan_tpu_torch" not in tops, path


def test_a_run_loads_no_forbidden_module():
    """A whole rehearsal in a fresh process, then sys.modules."""
    code = ("import sys; from perfbench import harness; "
            "harness.run_cell('beam70-loadcases', 7, 0.1, False, "
            "device='cpu', scale=(4, 2, 2)); "
            "print(harness.forbidden_modules(sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=PKG.parent,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
