"""The compact eigenvalue-constraint path (`paropt_torch.eig`) against
paropt_tpu.eig on the same numpy inputs, in float64:

- `EigenQuasiNewton.compact()` and ``.mult()`` under multiplier signs, the
  z0 -> 0 convention and with the QN-objective leg off (1e-12 relative),
  and the `CompactEigenApprox` model values (1e-12);
- the facade's `EigenSubproblem` (`Optimizer.set_trust_region_subproblem`,
  the reference's example wiring) on tests/test_eig.py's low-rank problem
  with N = 5: the same outer iterations, fobj to 1e-10 relative, x to 1e-8
  and the multiplier z[0] to 1e-8; with the filter method both packages
  stop at the restoration's QN reset with the same error;
- the host path on the 2-D frequency model
  (`FrequencyTopology.build_tr_subproblem`), port only: mass falls while
  the constraint is held."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paropt_tpu import eig as jeig
from paropt_tpu.ops import qn as jqn
from paropt_tpu.optimizer import Optimizer as JOptimizer
from paropt_torch import eig as teig
from paropt_torch.models.fem_frequency import FrequencyTopology
from paropt_torch.ops import qn as tqn
from paropt_torch.optimizer import Optimizer as TOptimizer
from paropt_torch.problem import Problem as TProblem
from paropt_torch.tr import TrustRegion

from ._torch_parity import assert_close, np_of
from .test_eig import LowRankConProblem as JLowRank
from .test_eig import _opts

torch.set_num_threads(1)
F64 = torch.float64


class TLowRank(TProblem):
    """tests/test_eig.py's LowRankConProblem in torch: min |x - 1|² s.t.
    r2 − |V x|² / 2 >= 0 (an exact low-rank constraint Hessian −VᵀV)."""

    def __init__(self, n=12, N=2, r2=1.0, seed=0):
        super().__init__(nvars=n, ncon=1)
        rng = np.random.default_rng(seed)
        self.V = torch.tensor(rng.standard_normal((N, n)) / np.sqrt(n))
        self.r2 = r2

    def objective(self, x):
        return torch.sum((x - 1.0) ** 2)

    def constraints(self, x):
        vx = self.V @ x
        return (self.r2 - 0.5 * torch.dot(vx, vx)).reshape(1)

    def get_vars_and_bounds(self):
        n = self.nvars
        return (torch.zeros(n, dtype=F64), torch.full((n,), -10.0, dtype=F64),
                torch.full((n,), 10.0, dtype=F64))


def _eigen_pair(n=8, N=3, seed=5):
    """The same (QN state with two pairs, M, Minv, h) in both packages."""
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((N, N))
    M = M @ M.T + 2 * np.eye(N)
    h = rng.standard_normal((N, n))
    s1, s2 = rng.standard_normal(n), rng.standard_normal(n)
    pairs = ((s1, 1.5 * s1), (s2, 2.0 * s2 + 0.1 * s1))
    jq, tq = jqn.qn_init(4, n), tqn.qn_init(4, n, dtype=F64, device="cpu")
    for s, y in pairs:
        jq, _, _ = jqn.qn_update(jq, jnp.asarray(s), jnp.asarray(y))
        tq, _, _ = tqn.qn_update(tq, torch.tensor(s), torch.tensor(y))
    je, te = jeig.CompactEigenApprox(n, N), teig.CompactEigenApprox(
        n, N, device="cpu")
    je.set_approximation(c0=0.3, g0=jnp.asarray(h[0]), M=jnp.asarray(M),
                         hvecs=jnp.asarray(h))
    te.set_approximation(c0=0.3, g0=torch.tensor(h[0]), M=torch.tensor(M),
                         hvecs=torch.tensor(h))
    return (jeig.EigenQuasiNewton(jq, je, 0), teig.EigenQuasiNewton(tq, te, 0),
            rng.standard_normal(n))


@pytest.mark.parametrize("qn_objective", [True, False])
@pytest.mark.parametrize("z0", [0.7, -0.4, 0.0])
def test_compact_and_mult_match_jax(z0, qn_objective):
    jq, tq, x = _eigen_pair()
    jq.use_quasi_newton_objective = qn_objective
    tq.use_quasi_newton_objective = qn_objective
    jq.update_multipliers(None, jnp.array([z0]), None)
    tq.update_multipliers(None, torch.tensor([z0], dtype=F64), None)
    for got, want in zip(tq.compact(), jq.compact()):
        assert_close(got, want, rtol=1e-12, atol=1e-14)
    assert_close(tq.mult(torch.tensor(x)), jq.mult(jnp.asarray(x)),
                 rtol=1e-12, atol=1e-12)


def test_compact_eigen_approx_matches_jax():
    jq, tq, x = _eigen_pair()
    je, te = jq.eigh, tq.eigh
    xt, xj = torch.tensor(x), jnp.asarray(x)
    assert_close(te.Minv, je.Minv, rtol=1e-12)      # the pinv default
    assert_close(te.eval_approximation(None), je.eval_approximation(None),
                 rtol=0.0)
    assert_close(te.eval_approximation(xt), je.eval_approximation(xj),
                 rtol=1e-12)
    assert_close(te.eval_approximation_gradient(xt),
                 je.eval_approximation_gradient(xj), rtol=1e-12)
    assert_close(te.mult_add(-0.7, xt), je.mult_add(-0.7, xj), rtol=1e-12)
    # update: the pair reaches the objective QN and z0 is refreshed
    s = np.random.default_rng(9).standard_normal(x.shape[0])
    jres = jq.update(None, jnp.array([0.25]), None, jnp.asarray(s),
                     jnp.asarray(1.3 * s))
    tres = tq.update(None, torch.tensor([0.25], dtype=F64), None,
                     torch.tensor(s), torch.tensor(1.3 * s))
    assert tres == jres
    assert float(tq.z0) == 0.25
    assert_close(tq.qn.buf, jq.qn.buf, rtol=1e-14)
    tq.reset()
    assert int(tq.qn.count) == 0


def _facade(pkg, **extra):
    """The reference's example wiring through each package's facade."""
    n, N = 16, 5
    if pkg == "jax":
        prob = JLowRank(n=n, N=N, seed=3)
        eigh = jeig.CompactEigenApprox(nvars=n, N=N)
        eqn = jeig.EigenQuasiNewton(jqn.qn_init(10, n), eigh, index=0)
        sub = jeig.EigenSubproblem(prob, eqn)
        M = -jnp.eye(N)
        opt = JOptimizer(prob, dict(_opts(dict(extra, algorithm="tr"))))
    else:
        prob = TLowRank(n=n, N=N, seed=3)
        eigh = teig.CompactEigenApprox(nvars=n, N=N, device="cpu")
        eqn = teig.EigenQuasiNewton(tqn.qn_init(10, n, dtype=F64,
                                                device="cpu"), eigh, index=0)
        sub = teig.EigenSubproblem(prob, eqn)
        M = -torch.eye(N, dtype=F64)
        opt = TOptimizer(prob, dict(_opts(dict(extra, algorithm="tr"))))
    V = prob.V
    sub.set_eigen_model_update(
        lambda x, e: e.set_approximation(M=M, hvecs=V))
    x0, _, _ = prob.get_vars_and_bounds()
    _, c0 = prob.eval_obj_con(x0)
    _, A0 = prob.eval_obj_con_gradient(x0)
    eigh.set_approximation(c0=c0[0], g0=A0[0], M=M, hvecs=V)
    opt.set_trust_region_subproblem(sub)
    res = opt.optimize()
    x, z, _, _, _ = opt.get_optimized_point()
    return res, np_of(x), np_of(z)


def test_facade_eigen_subproblem_matches_jax():
    jres, jx, jz = _facade("jax")
    tres, tx, tz = _facade("torch")
    assert tres["converged"] and jres["converged"]
    assert tres["niter"] == jres["niter"]
    np.testing.assert_allclose(tres["fobj"], jres["fobj"], rtol=1e-10)
    np.testing.assert_allclose(tx, jx, rtol=0.0, atol=1e-8)
    np.testing.assert_allclose(tz[0], jz[0], rtol=1e-8)
    assert tz[0] > 1e-8     # the constraint is active


def test_filter_restoration_fails_as_in_jax():
    """The filter method's feasibility restoration resets the QN holder
    with ``qn_reset``, which takes a QNState; with an EigenQuasiNewton in
    the holder both packages stop there with the same AttributeError
    (paropt_tpu/tr.py:902-909, paropt_torch/tr.py's `_filter_optimize`;
    ROADMAP queue 3)."""
    for pkg in ("jax", "torch"):
        with pytest.raises(AttributeError, match="'buf'"):
            _facade(pkg, tr_accept_step_strategy="filter_method")


def test_frequency_host_path_reduces_mass():
    """`build_tr_subproblem` on the 2-D frequency model through the host
    TrustRegion (tests/test_fem_frequency.py's options), 3 outer
    iterations: the design's mass falls below its start of 1 and the KS
    constraint stays within 5e-4 of feasible."""
    p = FrequencyTopology(8, 4, N=3, cg_iters=25, solver="mgcg",
                          lobpcg_iters=50, dtype=F64, device="cpu")
    sub, eigh = p.build_tr_subproblem(msub=10)
    opts = {"tr_output_file": None, "output_file": None,
            "tr_max_iterations": 3, "tr_init_size": 0.05,
            "tr_max_size": 0.2, "tr_min_size": 1e-6, "abs_res_tol": 1e-8,
            "tr_l1_tol": 1e-4, "tr_linfty_tol": 1e-4,
            "tr_adaptive_gamma_update": True, "penalty_gamma": 10.0}
    res = TrustRegion(p, opts, subproblem=sub).optimize()
    x = res["x"]
    assert res["niter"] == 3
    assert float(p.objective(x)) < 0.9
    assert p._eval(x)["ks"] > -5e-4
    # the model callback refreshed the curvature stack at accepted points
    assert torch.equal(eigh.hvecs, p._tensor(p._eval(x)["W"]))
