"""The port's example programs (``paropt_torch.examples``) held to the
repo's JAX scripts (``examples/*.py``), run in-process at the same reduced
arguments on the CPU in float64: the interior-point examples
(brachistochrone, ssto, cops_electron, sellar, sparse_rosenbrock,
topology) and the sparse Cholesky driver.  Tolerances
(tests/_torch_examples.py): integers equal, other numbers within one unit
of their last printed digit or 1e-8 relative, numbers below 1e-9 within
1e-9 absolute."""

import pytest
import torch

from ._torch_examples import compare, run_port

torch.set_num_threads(1)

CASES = {
    "brachistochrone": (["--nodes", "8"], None),
    "ssto": (["--nodes", "6"], None),
    "cops_electron": (["--n", "8"], None),
    "sellar": ([], r"^converged"),
    "sparse_rosenbrock": ([], r"^converged"),
    "topology": (["--n", "4096"], None),
    "cholesky": ([], None),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_example_matches_jax(name, monkeypatch, tmp_path, capsys):
    argv, start = CASES[name]
    out = compare(name, argv, monkeypatch, tmp_path, capsys, start)
    assert out is not None


def test_topology_jit_loop_and_chunk_reach_fused_ip(monkeypatch, tmp_path,
                                                    capsys):
    """``--jit-loop --chunk 7`` runs FusedIP.solve(jit_loop=True, chunk=7):
    the same solve, number for number, as the per-step default."""
    argv = ["--n", "4096"]
    _, _, steps = run_port("topology", argv, monkeypatch, tmp_path / "a",
                           capsys)
    _, _, windows = run_port("topology", argv + ["--jit-loop", "--chunk",
                                                 "7"],
                             monkeypatch, tmp_path / "b", capsys)
    assert windows == steps and steps["converged"]


def test_examples_import_no_jax():
    """Every example module imports without jax and without paropt_tpu,
    and there is one per script in examples/."""
    import subprocess
    import sys
    from pathlib import Path
    repo = Path(__file__).resolve().parent.parent
    names = sorted(p.stem for p in (repo / "examples").glob("*.py"))
    ported = sorted(p.stem for p in (repo / "paropt_torch" / "examples")
                    .glob("*.py") if not p.stem.startswith("_"))
    assert ported == names and len(names) == 20
    code = ("import sys, importlib; [importlib.import_module("
            "'paropt_torch.examples.' + n) for n in %r]; "
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib', 'paropt_tpu'))); "
            "print(bad); sys.exit(1 if bad else 0)" % (names,))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=str(repo))
    assert proc.returncode == 0, proc.stdout + proc.stderr
