"""The truss, cart-pole and COPS models of paropt_torch.models against
paropt_tpu.models in float64 on the CPU: values, gradients and Jacobians
at a seeded point to 1e-12, and one host InteriorPoint solve each with the
same iteration and evaluation counts, fobj to 1e-10 relative and x to
1e-8 (the DMO truss and the cart pole stop after a fixed count of
iterations: their full solves take hundreds of eager JAX iterations).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paropt_tpu.models import cartpole as jcp
from paropt_tpu.models import cops as jc
from paropt_tpu.models import truss as jt
from paropt_torch.models import (CartPole, DMOTruss, Electron, Polygon,
                                 TrussSizing)
from paropt_torch.models import truss as tt

from ._torch_parity import (assert_close, assert_same_ip_solve,
                            ip_side_by_side)

torch.set_num_threads(1)

F64 = dict(dtype=torch.float64, device="cpu")

MODELS = {
    "truss": (jt.TrussSizing, lambda: TrussSizing(**F64),
              {"abs_res_tol": 1e-6}),
    "dmo_truss": (lambda: jt.DMOTruss(4, 3), lambda: DMOTruss(4, 3, **F64),
                  {"abs_res_tol": 1e-5, "max_major_iters": 40}),
    "cartpole": (lambda: jcp.CartPole(nsteps=8),
                 lambda: CartPole(nsteps=8, **F64),
                 {"abs_res_tol": 1e-6, "max_major_iters": 8}),
    "polygon": (lambda: jc.Polygon(6), lambda: Polygon(6, **F64),
                {"abs_res_tol": 1e-6}),
    "electron": (lambda: jc.Electron(6), lambda: Electron(6, **F64),
                 {"abs_res_tol": 1e-6}),
}


def test_ground_structure_matches():
    for got, want in zip(tt.make_ground_structure(5, 4),
                         jt.make_ground_structure(5, 4)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_values_and_gradients_match(name):
    jmake, tmake, _ = MODELS[name]
    jp, tp = jmake(), tmake()
    assert (tp.nvars, tp.ncon, tp.nwcon, tp.ninequality) == (
        jp.nvars, jp.ncon, jp.nwcon, jp.ninequality)
    for got, want in zip(tp.get_vars_and_bounds(), jp.get_vars_and_bounds()):
        assert got.device.type == "cpu" and got.dtype == torch.float64
        assert_close(got, want, rtol=0.0)
    x0 = np.asarray(jp.get_vars_and_bounds()[0])
    rng = np.random.default_rng(1)
    x = x0 * (1.0 + 0.1 * rng.uniform(-1.0, 1.0, x0.shape))
    jx, tx = jnp.asarray(x), torch.as_tensor(x)
    for got, want in zip(tp.eval_obj_con(tx), jp.eval_obj_con(jx)):
        assert_close(got, want, rtol=1e-12, atol=1e-13)
    for got, want in zip(tp.eval_obj_con_gradient(tx),
                         jp.eval_obj_con_gradient(jx)):
        assert_close(got, want, rtol=1e-10, atol=1e-12)
    if tp.nwcon:
        px = rng.standard_normal(tp.nvars)
        assert_close(tp.eval_sparse_con(tx), jp.eval_sparse_con(jx),
                     rtol=1e-12)
        assert_close(tp.sparse_jacobian_vec(tx, torch.as_tensor(px)),
                     jp.sparse_jacobian_vec(jx, jnp.asarray(px)),
                     rtol=1e-12)
        assert tp.sparse_jacobian(tx).layout == "blocked"


@pytest.mark.parametrize("name", sorted(MODELS))
def test_host_ip_matches_jax(name, tmp_path):
    jmake, tmake, opts = MODELS[name]
    jr, tr, _, _ = ip_side_by_side(jmake(), tmake(), opts, tmp_path)
    if "max_major_iters" not in opts:
        assert jr["converged"]
    assert_same_ip_solve(jr, tr, tmp_path)


def test_cartpole_trajectory_matches():
    """The implicit-midpoint march (a Python loop of fixed Newton steps)
    against JAX's lax.scan, at a random force history."""
    u = np.random.default_rng(2).uniform(-5.0, 5.0, 8)
    got = CartPole(nsteps=8, **F64).trajectory(torch.as_tensor(u))
    want = jcp.CartPole(nsteps=8).trajectory(jnp.asarray(u))
    assert got.shape == (9, 4)
    assert_close(got, want, rtol=0.0, atol=1e-13)
