"""The analytic anchors: paropt_torch.models.analytic against
paropt_tpu.models.analytic in float64.

Each problem's start point and bounds, objective, dense and sparse
constraints, objective gradient and dense Jacobian (torch.func against
jax autodiff) and sparse Jacobian products agree to 1e-13 relative, at the
start point and at a seeded point inside the bounds."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paropt_tpu.models import analytic as ja
from paropt_torch.models import analytic as ta

from ._torch_parity import assert_rel

torch.set_num_threads(1)

F64 = torch.float64
EIGS = [1.0, 1.0, 4.0, 4.0, 9.0, 25.0]

CASES = {
    "rosenbrock": (ja.Rosenbrock, ta.Rosenbrock, {}),
    "rosenbrock-x0": (ja.Rosenbrock, ta.Rosenbrock, {"x0": [0.5, -0.25]}),
    "sparse-rosenbrock": (ja.SparseRosenbrock, ta.SparseRosenbrock, {}),
    "scalable-rosenbrock": (ja.ScalableRosenbrock, ta.ScalableRosenbrock,
                            {"n": 32, "group": 4}),
    "scalable-rosenbrock-dense": (ja.ScalableRosenbrock,
                                  ta.ScalableRosenbrock,
                                  {"n": 16, "use_sparse": False}),
    "random-convex-qp": (ja.RandomConvexQP, ta.RandomConvexQP,
                         {"n": 12, "ncon": 3, "seed": 4}),
    "sellar": (ja.Sellar, ta.Sellar, {}),
    "simple-quadratic": (ja.SimpleQuadratic, ta.SimpleQuadratic, {"n": 8}),
    "maratos": (ja.Maratos, ta.Maratos, {}),
    "random-quadratic": (ja.RandomQuadratic, ta.RandomQuadratic,
                         {"eigs": EIGS, "seed": 2}),
    "toy": (ja.Toy, ta.Toy, {}),
}


def _pair(name):
    jcls, tcls, kw = CASES[name]
    return jcls(**kw), tcls(**kw, dtype=F64, device="cpu")


def _points(jp):
    x0, lb, ub = (np.array(a, dtype=np.float64)
                  for a in jp.get_vars_and_bounds())
    rng = np.random.default_rng(7)
    inside = lb + (ub - lb) * rng.uniform(0.2, 0.8, x0.shape)
    return [x0, inside]


@pytest.mark.parametrize("name", sorted(CASES))
def test_analytic_problem_matches_jax(name):
    jp, tp = _pair(name)
    for attr in ("nvars", "ncon", "nwcon", "nwblock", "ninequality",
                 "nwinequality"):
        assert getattr(tp, attr) == getattr(jp, attr), attr
    for got, want in zip(tp.get_vars_and_bounds(), jp.get_vars_and_bounds()):
        assert got.dtype == F64
        assert_rel(got, want, rtol=0.0)
    for x in _points(jp):
        jx, tx = jnp.asarray(x), torch.as_tensor(x)
        jf, jc = jp.eval_obj_con(jx)
        tf, tc = tp.eval_obj_con(tx)
        assert_rel(tf, jf, rtol=1e-13, name="f")
        assert_rel(tc, jc, rtol=1e-13, name="c")
        jg, jA = jp.eval_obj_con_gradient(jx)
        tg, tA = tp.eval_obj_con_gradient(tx)
        assert_rel(tg, jg, rtol=1e-13, name="g")
        assert_rel(tA, jA, rtol=1e-13, name="A")
        if jp.nwcon:
            assert_rel(tp.eval_sparse_con(tx), jp.eval_sparse_con(jx),
                       rtol=1e-13, name="cw")
            px = np.random.default_rng(3).standard_normal(x.shape)
            zw = np.random.default_rng(5).standard_normal(jp.nwcon)
            assert_rel(tp.sparse_jacobian_vec(tx, torch.as_tensor(px)),
                       jp.sparse_jacobian_vec(jx, jnp.asarray(px)),
                       rtol=1e-13, name="Aw px")
            assert_rel(tp.sparse_jacobian_tvec(tx, torch.as_tensor(zw)),
                       jp.sparse_jacobian_tvec(jx, jnp.asarray(zw)),
                       rtol=1e-13, name="Aw' zw")
            assert tp.sparse_jacobian(tx).layout == \
                jp.sparse_jacobian(jx).layout


@pytest.mark.parametrize("name", ["simple-quadratic", "maratos"])
def test_known_solutions(name):
    jp, tp = _pair(name)
    assert_rel(tp.solution(), jp.solution(), rtol=1e-15)


def test_float32_and_device_are_honoured():
    p = ta.Sellar(dtype=torch.float32, device="cpu")
    x0, lb, ub = p.get_vars_and_bounds()
    assert x0.dtype == lb.dtype == ub.dtype == torch.float32
    f, c = p.eval_obj_con(x0)
    g, A = p.eval_obj_con_gradient(x0)
    assert f.dtype == c.dtype == g.dtype == A.dtype == torch.float32
    assert A.shape == (2, 4)
