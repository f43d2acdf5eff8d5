"""No run loads JAX or the JAX package, and the plain references import
neither those nor the program.  Module names are compared by their whole
top-level part (the port's package name begins with the JAX package's)."""

import ast
import subprocess
import sys
from pathlib import Path

from portbench import harness

REFERENCE = harness.BENCH / "reference"
FORBIDDEN = {"jax", "jaxlib", "flax", "paropt_tpu"}


def _imports(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_references_import_neither_jax_nor_the_program():
    for path in REFERENCE.glob("*.py"):
        assert not _imports(path) & (FORBIDDEN | {"paropt_torch"}), path


def test_references_load_nothing_forbidden():
    code = ("import sys, importlib, pathlib\n"
            f"sys.path.insert(0, {str(harness.ROOT)!r})\n"
            "for p in pathlib.Path(sys.argv[1]).glob('*.py'):\n"
            "    importlib.import_module('portbench.reference.' + p.stem)\n"
            "bad = {m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'paropt_tpu', 'paropt_torch'}\n"
            "print(sorted(bad))\n")
    out = subprocess.run([sys.executable, "-c", code, str(REFERENCE)],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_a_run_loads_nothing_forbidden():
    """A whole run of each cell at the small size, in a process of its own:
    no top-level module named jax, jaxlib, flax or paropt_tpu."""
    code = ("import sys\n"
            f"sys.path.insert(0, {str(harness.ROOT)!r})\n"
            "from portbench.tests._small import IP, MMA, run_small\n"
            "for cell in (IP, MMA):\n"
            "    result, _ = run_small(cell, seconds=0.2)\n"
            "    assert result['attempted'] > 0\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'paropt_tpu'}))\n"
            "print('paropt_torch' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split() == ["[]", "True"]


def test_forbidden_names_are_whole_top_level_names():
    sys.modules.setdefault("paropt_tpu_like", type(sys)("paropt_tpu_like"))
    try:
        assert "paropt_tpu_like" not in harness.forbidden_modules()
    finally:
        del sys.modules["paropt_tpu_like"]
