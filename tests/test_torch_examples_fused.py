"""The port's example programs held to the repo's JAX scripts (see
tests/test_torch_examples_ip.py for the rule and its tolerances): the
fused trust regions, FusedTR with its batched multi-start
(fem_topology_tr) and FusedEigenTR (fem_frequency), each in its default
'auto' windows."""

import pytest
import torch

from ._torch_examples import compare

torch.set_num_threads(1)

CASES = {
    "fem_topology_tr": (["--nex", "8", "--ney", "4", "--iters", "3",
                         "--starts", "2"], None),
    "fem_frequency": (["--nex", "8", "--ney", "4", "--N", "3",
                       "--iters", "3"], None),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_example_matches_jax(name, monkeypatch, tmp_path, capsys):
    argv, start = CASES[name]
    out = compare(name, argv, monkeypatch, tmp_path, capsys, start)
    assert out is not None
