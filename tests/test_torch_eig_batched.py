"""Batched eigen-TR solves: `ops.lobpcg.lobpcg_standard_batched` and
`FusedEigenTR.solve_batched` against the port's single solves and against
paropt_tpu (``jax.vmap`` of its LOBPCG; its ``solve_batched``), on the
same numpy inputs in float64:

- the batched LOBPCG on kb = 4 dense SPD operators (n = 200, k = 4; two
  converge early at different counts, one runs to the cap m): per
  instance the single solve's count and eigenvalues within 1e-12, the
  kb = 1 batch's iterates bit for bit (a finished instance's carry is
  frozen), one host read per block iteration; and JAX's vmapped counts
  with eigenvalues within 1e-10.  The spectra have a decisive exit: the
  exit test at an eps-scale tolerance is decided by roundoff for slowly
  converging spectra (ROADMAP queue 3), where no two summation orders
  need agree on the count;
- `FusedEigenTR.solve_batched` on FrequencyTopology(8, 4, N=3, mgcg) with
  kb = 3 starts and 4 outer iterations against paropt_tpu's: per-instance
  niter and inner iterations equal, fobj within 1e-9 relative, x within
  1e-7, each eigensolve's per-instance LOBPCG counts those of the
  instance's own single solve; and on a tiny problem without a batched
  evaluation (eval_full under torch.func.vmap), each instance equal to
  its single solve."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.sparse import linalg as jlinalg

from paropt_torch.ip import HostSyncs
from paropt_torch.ops import lobpcg as tlobpcg

torch.set_num_threads(1)
F64 = torch.float64
N, K, M = 200, 4, 40


def _operators():
    """kb = 4 SPD matrices with chosen top spectra (the rest uniform in
    [0.1, 1]) and their start blocks."""
    tops = ((10, [20, 16, 12, 8, 4]), (11, [10, 9, 8, 7, 3]),
            (12, [1 + 1e-3 * i for i in range(8)][::-1]),
            (13, [6, 5.5, 5, 4.5, 2]))
    As, Xs = [], []
    for seed, top in tops:
        rng = np.random.default_rng(seed)
        Q, _ = np.linalg.qr(rng.standard_normal((N, N)))
        ev = np.concatenate([top, rng.uniform(0.1, 1.0, N - len(top))])
        As.append((Q * ev) @ Q.T)
        Xs.append(rng.standard_normal((N, K)))
    return np.stack(As), np.stack(Xs)


def test_batched_lobpcg_matches_single_solves():
    A, X = (torch.tensor(a) for a in _operators())
    syncs = HostSyncs()
    theta, U, iters = tlobpcg.lobpcg_standard_batched(
        lambda v: A @ v, X, m=M, syncs=syncs)
    assert len(set(iters)) > 2 and max(iters) == M    # early and capped
    assert syncs.count == max(iters)
    for j in range(A.shape[0]):
        t1, _, i1 = tlobpcg.lobpcg_standard(lambda v: A[j] @ v, X[j], m=M)
        assert iters[j] == i1
        np.testing.assert_allclose(theta[j].numpy(), t1.numpy(),
                                   rtol=1e-12)
        # alone in a batch: the same iterates, bit for bit, so the
        # instance's carry froze when it finished
        tb, Ub, ib = tlobpcg.lobpcg_standard_batched(
            lambda v: A[j:j + 1] @ v, X[j:j + 1], m=M)
        assert ib == [iters[j]]
        assert torch.equal(tb[0], theta[j]) and torch.equal(Ub[0], U[j])


def test_batched_lobpcg_matches_jax_vmap():
    A, X = _operators()
    jt, _, ji = jax.vmap(lambda a, x: jlinalg.lobpcg_standard(
        lambda v: a @ v, x, m=M))(jnp.asarray(A), jnp.asarray(X))
    At = torch.tensor(A)
    theta, _, iters = tlobpcg.lobpcg_standard_batched(
        lambda v: At @ v, torch.tensor(X), m=M)
    assert iters == np.asarray(ji).tolist()
    np.testing.assert_allclose(theta.numpy(), np.asarray(jt), rtol=1e-10)


FREQ_OPTS = {"tr_output_file": None, "output_file": None,
             "tr_max_iterations": 4, "tr_init_size": 0.05,
             "tr_max_size": 0.2, "tr_min_size": 1e-6, "abs_res_tol": 1e-8,
             "tr_l1_tol": 1e-4, "tr_linfty_tol": 1e-4,
             "tr_adaptive_gamma_update": True, "penalty_gamma": 10.0,
             "dtype": "float64"}
FREQ_KW = dict(N=3, cg_iters=25, solver="mgcg", lobpcg_iters=50)
_CACHE = {}


def _starts(nvars):
    """x0 = 1 and two starts inside the bounds [0.05, 1]."""
    rng = np.random.default_rng(0)
    return np.vstack([np.ones(nvars),
                      np.clip(rng.uniform(0.6, 1.0, (2, nvars)), 0.05, 1.0)])


def _jax_batched():
    """paropt_tpu's batched solve, run once per module (~20 s, most of it
    compiling)."""
    if "jax" not in _CACHE:
        from paropt_tpu.models.fem_frequency import FrequencyTopology
        prob = FrequencyTopology(8, 4, dtype=jnp.float64, **FREQ_KW)
        res, st = prob.build_fused_tr(dict(FREQ_OPTS)).solve_batched(
            jnp.asarray(_starts(prob.nvars)))
        _CACHE["jax"] = ({k: np.asarray(v) for k, v in res.items()},
                         np.asarray(st.subiters))
    return _CACHE["jax"]


def _torch_freq(x0=None):
    from paropt_torch.models.fem_frequency import FrequencyTopology
    prob = FrequencyTopology(8, 4, dtype=F64, device="cpu", **FREQ_KW)
    if x0 is not None:
        base = prob.get_vars_and_bounds

        def with_start():
            _, lb, ub = base()
            return torch.tensor(x0), lb, ub
        prob.get_vars_and_bounds = with_start
    return prob


def test_solve_batched_matches_jax_and_single_solves():
    jres, jsub = _jax_batched()
    prob = _torch_freq()
    x0s = _starts(prob.nvars)
    solver = prob.build_fused_tr(dict(FREQ_OPTS))
    start = len(prob.lobpcg_iters_log)
    res, st = solver.solve_batched(torch.tensor(x0s))
    assert set(res) == set(jres)
    np.testing.assert_array_equal(res["niter"], jres["niter"])
    np.testing.assert_array_equal(st.subiters.numpy(), jsub)
    np.testing.assert_allclose(res["fobj"], jres["fobj"], rtol=1e-9)
    np.testing.assert_allclose(res["x"].numpy(), jres["x"], rtol=0.0,
                               atol=1e-7)
    assert np.all(res["fobj"] < 1.0)
    # each eigensolve records its kb counts; the start's, then one per
    # outer iteration; every instance keeps its own warm basis
    solves = prob.lobpcg_iters_log[start:]
    assert len(solves) == 1 + int(res["niter"].max())
    assert all(len(s) == 3 for s in solves)
    assert st.V.shape == (3, prob.fem.ndof, 3)
    # instance 1 against its own single solve
    one = _torch_freq(x0s[1])
    single = one.build_fused_tr(dict(FREQ_OPTS))
    s0 = len(one.lobpcg_iters_log)
    r1, s1 = single.solve()
    assert (r1["niter"], int(s1.subiters)) == (int(res["niter"][1]),
                                               int(st.subiters[1]))
    assert one.lobpcg_iters_log[s0:] == [s[1] for s in solves[1:]]
    np.testing.assert_allclose(r1["fobj"], res["fobj"][1], rtol=1e-9)


def test_solve_batched_without_a_batched_evaluation():
    """A problem with eval_full alone is priced under torch.func.vmap;
    each instance equals its single solve, and the chunked form ends on the
    same bits."""
    from paropt_torch.eig_fused import EigModel, FusedEigenTR

    from .test_eig_fused_step import _opts
    from .test_torch_eig_fused import TTiny
    solver = FusedEigenTR(TTiny(n=8, N=2, seed=2),
                          dict(_opts({"tr_max_iterations": 5})), index=1,
                          qn_b0=1.0)
    s0 = solver._state0
    xs = torch.stack([s0.xk, 0.5 * s0.xk, s0.xk + 0.2])
    res, st = solver.solve_batched(xs)
    for j in range(3):
        f, c, g, A, Me, Mi, h, _ = solver._step.args[0](xs[j])
        r1, s1 = solver.solve(state0=dataclasses.replace(
            s0, xk=xs[j], fk=f, ck=c, gk=g, Ak=A,
            eig=EigModel(M=Me, Minv=Mi, h=h)))
        assert (r1["niter"], int(s1.subiters)) == (int(res["niter"][j]),
                                                   int(st.subiters[j]))
        np.testing.assert_allclose(st.xk[j].numpy(), s1.xk.numpy(),
                                   rtol=0.0, atol=1e-12)
    res2, st2 = solver.solve_batched(xs, chunk=2)
    np.testing.assert_array_equal(res2["niter"], res["niter"])
    assert torch.equal(st2.xk, st.xk)
