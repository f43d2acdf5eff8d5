"""The port's example programs held to the repo's JAX scripts (see
tests/test_torch_examples_ip.py for the rule and its tolerances): the FEM
topology examples through the host MMA (fem_topology), FusedMMA in
windows of 2 (fem_topology3d), the host IP (dmo_topology) and the host
MMA on the DMO truss (dmo_truss)."""

import pytest
import torch

from ._torch_examples import compare

torch.set_num_threads(1)

CASES = {
    "fem_topology": (["--nex", "8", "--ney", "4", "--iters", "5"],
                     r"^compliance"),
    "fem_topology3d": (["--nex", "4", "--ney", "2", "--nez", "2",
                        "--iters", "3", "--chunk", "2"], None),
    "dmo_topology": (["--nex", "4", "--ney", "2"], None),
    "dmo_truss": ([], r"^compliance"),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_example_matches_jax(name, monkeypatch, tmp_path, capsys):
    argv, start = CASES[name]
    out = compare(name, argv, monkeypatch, tmp_path, capsys, start)
    assert out is not None
