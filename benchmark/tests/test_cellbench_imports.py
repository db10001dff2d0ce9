"""Import hygiene: nothing the benchmark loads has the top-level name jax,
jaxlib, flax or pyrenderer_tpu (the JAX package), compared as whole names
since the program's own name begins with the JAX package's; and the plain
reference imports nothing of the program either."""

from __future__ import annotations

import ast
import subprocess
import sys

from benchmark import harness
from conftest import ROOT

BENCH = ROOT / "benchmark"


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_no_source_of_the_benchmark_imports_jax():
    for path in BENCH.rglob("*.py"):
        assert not _imported_roots(path) & set(harness.FORBIDDEN), path


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        assert "pyrenderer_tpu_torch" not in _imported_roots(path), path


def _modules_after(code):
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(sorted({m.split('.')[0] for m in sys.modules}))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_the_reference_loads_nothing_of_the_program():
    roots = _modules_after("import benchmark.reference.render, benchmark.reference.scene, "
                           "benchmark.compare")
    assert not roots & {"pyrenderer_tpu_torch", *harness.FORBIDDEN}


def test_a_run_loads_no_jax():
    """A whole cell run on the CPU (8 x 8): the program and the harness load
    no module of JAX or of the JAX package."""
    code = (
        "import json, sys\n"
        "sys.path.insert(0, 'benchmark/tests')\n"
        "from conftest import small_cell\n"
        "from benchmark import harness\n"
        "bench = json.load(open('BENCHMARK.json'))\n"
        "cell = small_cell('cornell.render', bench, res=8)\n"
        "harness.load_cell = lambda *a, **k: cell\n"
        "res = harness.run_cell('cornell.render', 5, 0.2, True, device='cpu')\n"
        "assert res['correct'], res\n"
        "assert harness.forbidden_modules() == []\n")
    roots = _modules_after(code)
    assert "pyrenderer_tpu_torch" in roots
    assert not roots & set(harness.FORBIDDEN)


def test_forbidden_modules_compares_whole_names(monkeypatch):
    for name in ("pyrenderer_tpu_torch_extra", "jaxtyping", "jax_fake_mod"):
        monkeypatch.setitem(sys.modules, name, object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "pyrenderer_tpu.core", object())
    monkeypatch.setitem(sys.modules, "jax", object())
    assert harness.forbidden_modules() == ["jax", "pyrenderer_tpu"]
