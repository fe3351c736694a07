"""No module of the benchmark imports JAX, its relatives or the JAX
package (``repro``, compared by the whole top-level name: the port's name,
``repro_torch``, begins with it); the reference imports nothing of the
program; and a run loads none of them."""
import ast
import subprocess
import sys

import pytest

from portbench import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
MODULES = sorted(p for p in spec.PKG.rglob("*.py")
                 if ".cache" not in p.parts)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield node.args[0].value


@pytest.mark.parametrize("path", MODULES,
                         ids=[str(p.relative_to(spec.ROOT)) for p in MODULES])
def test_no_jax_and_no_jax_package(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & FORBIDDEN, tops & FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    for path in (spec.PKG / "reference").rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert tops <= {"__future__", "numpy"}, (path, tops)


def test_a_run_loads_none_of_them():
    code = (
        "import sys, time\n"
        "sys.path.insert(0, 'src')\n"
        "from portbench import run\n"
        "from portbench.tests.small import run_cell, run_small, "
        "sharded_cell\n"
        "run_cell(sharded_cell(), steps=1, trace=True)\n"
        "run_small('covid-200M.w4-read-heavy', steps=1)\n"
        "print(run.forbidden_modules(), 'repro_torch' in sys.modules)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1] == "[] True"
