"""`FusedMMA.solve_batched` and `FusedTR.solve_batched` on the 2-D FEM
(8×4, Jacobi CG 200 iterations, f64): k = 3 multi-start solves as one, on
the configurations of `tests/test_mma.py:182-210` and
`tests/test_tr.py:270-302`, held to the port's own single solves and to
paropt_tpu's batched solves.

Tolerances, the JAX tests' own: equal niter, fobj 1e-9 relative, x 1e-9
absolute (measured against the port's single solves: fobj within 2e-15,
x within 2e-13).  Each JAX batch is computed once per module.
"""

import dataclasses
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paropt_tpu.models.fem_topology import FEMTopology as JFEM
from paropt_tpu.mma import FusedMMA as JFusedMMA
from paropt_tpu.tr import FusedTR as JFusedTR
from paropt_torch.models.fem_topology import FEMTopology as TFEM
from paropt_torch.mma import FusedMMA as TFusedMMA
from paropt_torch.tr import FusedTR as TFusedTR
from paropt_torch.tree import bvmap

torch.set_num_threads(1)

F64 = torch.float64
MMA_OPTS = {"mma_max_iterations": 15, "mma_output_file": None}
TR_OPTS = {"tr_output_file": None, "output_file": None,
           "tr_max_iterations": 10, "abs_res_tol": 1e-7,
           "tr_infeas_tol": 1e-5, "tr_l1_tol": 0.0, "tr_linfty_tol": 1e-5}


def _starts(x0, seed):
    rng = np.random.default_rng(seed)
    return np.clip(np.asarray(x0)[None, :]
                   * rng.uniform(0.6, 1.4, size=(3, x0.shape[0])), 0.05,
                   0.95)


def _tprob():
    return TFEM(nex=8, ney=4, cg_iters=200, dtype=F64, device="cpu")


def _no_fallback(fn, *args):
    """fn(*args) with PyTorch's warning that vmap fell back to a
    per-instance loop (an op without a batching rule) made an error."""
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=".*batching rule.*")
        return fn(*args)


def _check_results(res, want, names):
    for key in names:
        np.testing.assert_allclose(res[key], want[key], rtol=1e-9,
                                   err_msg=key)


def test_fused_mma_solve_batched_multistart():
    jprob = JFEM(nex=8, ney=4, cg_iters=200)
    jx0, _, _ = jprob.get_vars_and_bounds()
    x0s = _starts(jx0, 0)
    jres, _ = JFusedMMA(jprob, MMA_OPTS).solve_batched(jnp.asarray(x0s))

    solver = TFusedMMA(_tprob(), MMA_OPTS)
    res, states = _no_fallback(solver.solve_batched, torch.as_tensor(x0s))
    assert res["fobj"].shape == (3,)
    assert np.all(np.isfinite(res["fobj"])) and np.all(res["infeas"] < 1e-5)
    assert states.x.shape == (3, 32)
    np.testing.assert_array_equal(res["niter"], np.asarray(jres["niter"]))
    np.testing.assert_array_equal(res["converged"],
                                  np.asarray(jres["converged"]))
    _check_results(res, {k: np.asarray(v) for k, v in jres.items()},
                   ("fobj",))
    for i in range(3):
        xi = torch.as_tensor(x0s[i])
        r1, st1 = solver.solve(dataclasses.replace(solver._state0, x=xi,
                                                   x1=xi, x2=xi))
        assert res["niter"][i] == r1["niter"]
        assert int(states.subiters[i]) == int(st1.subiters)
        np.testing.assert_allclose(res["fobj"][i], r1["fobj"], rtol=1e-9)
        np.testing.assert_allclose(states.x[i].numpy(), r1["x"].numpy(),
                                   atol=1e-9)


def test_fused_tr_solve_batched_multistart():
    jprob = JFEM(nex=8, ney=4, cg_iters=200)
    jx0, _, _ = jprob.get_vars_and_bounds()
    x0s = _starts(jx0, 1)
    jres, _ = JFusedTR(jprob, TR_OPTS).solve_batched(jnp.asarray(x0s))

    fus = TFusedTR(_tprob(), TR_OPTS)
    res, states = _no_fallback(fus.solve_batched, torch.as_tensor(x0s))
    assert res["fobj"].shape == (3,)
    assert np.all(np.isfinite(res["fobj"])) and np.all(res["infeas"] < 1e-5)
    np.testing.assert_array_equal(res["niter"], np.asarray(jres["niter"]))
    np.testing.assert_array_equal(res["converged"],
                                  np.asarray(jres["converged"]))
    _check_results(res, {k: np.asarray(v) for k, v in jres.items()},
                   ("fobj",))
    for i in range(3):
        xv = torch.as_tensor(x0s[i])
        f0, c0, cw0 = fus._ev((), xv)
        g0, A0 = fus._gr((), xv)
        r2, st2 = fus.solve(dataclasses.replace(
            fus._state0, xk=xv, fk=f0, ck=c0, gk=g0, Ak=A0, cwk=cw0))
        assert res["niter"][i] == r2["niter"]
        assert int(states.subiters[i]) == int(st2.subiters)
        np.testing.assert_allclose(res["fobj"][i], r2["fobj"], rtol=1e-9)
        np.testing.assert_allclose(states.xk[i].numpy(), r2["x"].numpy(),
                                   atol=1e-9)


@pytest.mark.parametrize("solver", ["jacobi", "mgcg"])
def test_fem_evaluation_under_vmap_has_batching_rules(solver):
    """The FEM objective, its adjoint gradient (`_Compliance`) and the
    constraints under ``torch.func.vmap``: no op falls back to a
    per-instance loop (PyTorch's fallback warning is made an error), and
    each instance equals its own evaluation."""
    prob = TFEM(nex=8, ney=4, cg_iters=25, solver=solver, dtype=F64,
                device="cpu")
    x0, _, _ = prob.get_vars_and_bounds()
    xs = torch.as_tensor(_starts(x0.numpy(), 2))

    def ev(x):
        f, c = prob.eval_obj_con(x)
        g, A = prob.eval_obj_con_gradient(x)
        return f, c, g, A

    out = _no_fallback(bvmap, ev, (0,), xs)
    for i in range(3):
        for got, want in zip(out, ev(xs[i])):
            np.testing.assert_allclose(got[i].numpy(), want.numpy(),
                                       rtol=1e-12, atol=1e-14)
