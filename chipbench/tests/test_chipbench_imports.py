"""Nothing of the benchmark loads JAX or the JAX package, the reference
loads nothing of the program, and nothing reads the JAX-era benchmarks."""

from __future__ import annotations

import ast
import re
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


def test_no_file_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        assert not (_imports(path) & FORBIDDEN), path


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        assert "repro_torch" not in _imports(path), path


def test_nothing_reads_the_jax_benchmarks():
    for path in BENCH.rglob("*"):
        if path.suffix in (".py", ".json") and "tests" not in path.parts:
            assert not re.search(r"BENCH_\w*\.json|benchmarks/|experiments/",
                                 path.read_text()), path


def test_a_run_holds_no_jax_module():
    code = (
        "import sys, time; sys.path[:0] = [%r, %r]\n"
        "from chipbench.tests.conftest import tiny_cell\n"
        "from chipbench.harness.cell import run_cell\n"
        "from chipbench.run import forbidden_modules\n"
        "res, _ = run_cell(tiny_cell(), seed=3, seconds=0.5, trace=False, device='cpu',"
        " t_start=time.perf_counter())\n"
        "assert res['correct'], res\n"
        "print('FORBIDDEN', forbidden_modules())\n" % (str(ROOT / "src"), str(ROOT)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FORBIDDEN []" in out.stdout


def test_the_forbidden_check_compares_whole_names(monkeypatch):
    from chipbench import run

    monkeypatch.setitem(sys.modules, "repro_torch_fake", object())
    assert "repro" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro", object())
    assert "repro" in run.forbidden_modules()
