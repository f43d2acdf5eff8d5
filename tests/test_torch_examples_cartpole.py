"""The port's cart_pole example held to examples/cart_pole.py (see
tests/test_torch_examples_ip.py for the rule and its tolerances), at 3
steps: the JAX script's eager model evaluations take ~3 s per interior-
point iteration on a CPU, so this file holds it alone (~50 s)."""

import torch

from ._torch_examples import compare

torch.set_num_threads(1)


def test_example_matches_jax(monkeypatch, tmp_path, capsys):
    out = compare("cart_pole", ["--nsteps", "3"], monkeypatch, tmp_path,
                  capsys)
    assert out["converged"] and out["niter"] > 1
