"""The port's example programs held to the repo's JAX scripts (see
tests/test_torch_examples_ip.py for the rule and its tolerances): the
trust-region and facade examples (rosenbrock, maratos, eigenvalue,
reduced_problem, small_problems) and openmdao_paraboloid, which ends with
the JAX script's own message without openmdao and runs through a
stand-in (tests/_fake_openmdao.py's Driver under a small Problem) with
it."""

import pytest
import torch

from ._torch_examples import compare, fake_openmdao

torch.set_num_threads(1)

CASES = {
    "rosenbrock": ([], r"^converged"),
    "maratos": ([], r"^converged"),
    "maratos-ip": (["--algorithm", "ip"], r"^converged"),
    "eigenvalue": ([], r"^converged"),
    "reduced_problem": ([], None),
    "small_problems": (["--starts", "1"], None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_example_matches_jax(case, monkeypatch, tmp_path, capsys):
    argv, start = CASES[case]
    out = compare(case.split("-")[0], argv, monkeypatch, tmp_path, capsys,
                  start)
    assert out is not None


def test_openmdao_paraboloid_without_openmdao(monkeypatch, tmp_path, capsys):
    import sys
    monkeypatch.setitem(sys.modules, "openmdao", None)
    monkeypatch.setitem(sys.modules, "openmdao.api", None)
    out = compare("openmdao_paraboloid", [], monkeypatch, tmp_path, capsys)
    assert out is None


def test_openmdao_paraboloid_through_a_stand_in(monkeypatch, tmp_path,
                                                capsys):
    fake_openmdao(monkeypatch)
    out = compare("openmdao_paraboloid", [], monkeypatch, tmp_path, capsys)
    assert abs(out["c"] - 27.0) < 1e-6
