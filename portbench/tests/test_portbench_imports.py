"""No module of the benchmark loads JAX, Flax or the JAX package, and the
reference loads nothing of the program."""
from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "gear_tpu"}


def imported(path: Path) -> set[str]:
    """Top-level names of every module the file imports."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_no_file_imports_jax_or_the_jax_package():
    files = [p for p in BENCH.rglob("*.py") if "tests" not in p.parts]
    assert files
    for p in files:
        assert not imported(p) & FORBIDDEN, p


def test_the_reference_imports_nothing_of_the_program():
    for p in (BENCH / "reference").glob("*.py"):
        assert imported(p) <= {"__future__", "math", "torch"}, p


def test_a_run_loads_no_forbidden_module():
    code = (
        "import sys; sys.argv = ['run.py', '--workload', "
        "'mistral7b-gear4-decode-4k', '--seed', '5', '--seconds', '0.2', "
        "'--trace', '0', '--rehearse']\n"
        "import runpy; runpy.run_path('portbench/run.py', run_name='__main__')\n"
        "bad = sorted({m.split('.')[0] for m in sys.modules} & "
        + repr(FORBIDDEN) + ")\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=BENCH.parent,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
