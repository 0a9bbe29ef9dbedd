"""Nothing the benchmark runs imports JAX or nero_tpu (top-level names
compared whole: nero_tpu_torch is the program and allowed), and the
reference and the photos both sides read import nothing of the program."""
from __future__ import annotations

import ast
import glob
import os
import subprocess
import sys

from benchmark.harness import catalog

FORBIDDEN = {"jax", "jaxlib", "flax", "nero_tpu"}


def imported(path: str) -> set:
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_of_the_benchmark_imports_jax_or_nero_tpu():
    files = glob.glob(os.path.join(catalog.HERE, "**", "*.py"), recursive=True)
    assert len(files) > 20
    for path in files:
        assert not imported(path) & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_program():
    for path in glob.glob(os.path.join(catalog.HERE, "reference", "*.py")) + [
            os.path.join(catalog.HERE, "harness", "photos.py")]:
        assert "nero_tpu_torch" not in imported(path), path
    code = ("import sys; import benchmark.reference.stage1; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=os.path.dirname(catalog.HERE),
                         capture_output=True, text=True, check=True).stdout
    loaded = set(eval(out))
    assert not loaded & (FORBIDDEN | {"nero_tpu_torch"})
