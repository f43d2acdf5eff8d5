"""The fused eigen trust region (`paropt_torch.eig_fused`) against
paropt_tpu.eig_fused on the same numpy inputs, in float64:

- `_merged_compact` for multiplier signs, z0 = 0 and no objective QN
  (1e-13 relative);
- one `_fused_eig_tr_step` of each package from the same JAX state
  (`convert.fused_eig_tr_state`) on tests/test_eig_fused_step.py's tiny
  problem (a linear row and an exact low-rank quadratic eigen row at
  index 1): its accept case from the start and from two steps in (a QN
  history and a nonzero z0), and its reject case (a quartic the model
  cannot see); every state field to 1e-9 relative (1e-12 for the
  accept/reject selects of the state);
- the whole `FusedEigenTR.solve` on FrequencyTopology(8, 4, N=3, mgcg)
  with bench.py's eigen-TR options, 6 outer iterations, for both
  ``eig_row_model`` values: equal niter and subiters, fobj to 1e-9
  relative, x to 1e-7;
- the port's own: the non-finite fail-stop, the warm-start basis riding
  the state, the write-output and checkpoint cadence, and the chunked
  solve, which is not ported."""

import dataclasses
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paropt_tpu import eig_fused as jef
from paropt_tpu.models.fem_frequency import FrequencyTopology as JFreq
from paropt_tpu.ops import qn as jqn
from paropt_torch import convert
from paropt_torch import eig_fused as tef
from paropt_torch.models.fem_frequency import FrequencyTopology as TFreq
from paropt_torch.ops import qn as tqn
from paropt_torch.problem import Problem as TProblem

from ._torch_parity import assert_close, assert_fields_close, fields_of
from .test_eig_fused_step import TinyEigProblem as JTiny
from .test_eig_fused_step import _opts

torch.set_num_threads(1)
F64 = torch.float64


class TTiny(TProblem):
    """tests/test_eig_fused_step.py's TinyEigProblem in torch."""

    def __init__(self, n=8, N=2, r2=1.0, quartic=0.0, seed=0):
        super().__init__(nvars=n, ncon=2)
        rng = np.random.default_rng(seed)
        self.V = torch.tensor(rng.standard_normal((N, n)) / np.sqrt(n))
        self.N = N
        self.r2 = r2
        self.quartic = quartic

    def objective(self, x):
        f = torch.sum((x - 1.0) ** 2)
        if self.quartic:
            f = f + self.quartic * torch.sum(x ** 4)
        return f

    def constraints(self, x):
        vx = self.V @ x
        return torch.stack([torch.sum(x) / self.nvars + 0.5,
                            self.r2 - 0.5 * torch.dot(vx, vx)])

    def get_vars_and_bounds(self):
        n = self.nvars
        return (torch.full((n,), 0.1, dtype=F64),
                torch.full((n,), -10.0, dtype=F64),
                torch.full((n,), 10.0, dtype=F64))

    def eval_full(self, x):
        f, c = self.eval_obj_con(x)
        g, A = self.eval_obj_con_gradient(x)
        M = -torch.eye(self.N, dtype=x.dtype)
        return f, c, g, A, M, M.clone(), self.V


def test_merged_compact_matches_jax():
    n, N = 8, 3
    rng = np.random.default_rng(11)
    M = rng.standard_normal((N, N))
    M = M @ M.T + 2 * np.eye(N)
    Minv = np.linalg.inv(M)
    h = rng.standard_normal((N, n))
    jq, tq = jqn.qn_init(4, n), tqn.qn_init(4, n, dtype=F64, device="cpu")
    for s, y in ((1.0, 1.5), (2.0, 0.7)):
        sv = rng.standard_normal(n)
        jq, _, _ = jqn.qn_update(jq, jnp.asarray(s * sv),
                                 jnp.asarray(y * sv))
        tq, _, _ = tqn.qn_update(tq, torch.tensor(s * sv),
                                 torch.tensor(y * sv))
    je = jef.EigModel(M=jnp.asarray(M), Minv=jnp.asarray(Minv),
                      h=jnp.asarray(h))
    te = tef.EigModel(M=torch.tensor(M), Minv=torch.tensor(Minv),
                      h=torch.tensor(h))
    for qn_pair in ((jq, tq), (None, None)):
        for z0 in (0.7, -0.4, 0.0):
            want = jef._merged_compact(qn_pair[0], je, jnp.asarray(z0),
                                       jnp.float64)
            got = tef._merged_compact(qn_pair[1], te,
                                      torch.tensor(z0, dtype=F64), F64)
            for a, b in zip(got, want):
                assert_close(a, b, rtol=1e-13, atol=1e-15)


def _solvers(quartic=0.0, extra=None, index=1):
    opts = _opts(extra)
    jf = jef.FusedEigenTR(JTiny(n=8, N=2, seed=2, quartic=quartic),
                          dict(opts), index=index, qn_b0=1.0)
    tf = tef.FusedEigenTR(TTiny(n=8, N=2, seed=2, quartic=quartic),
                          dict(opts), index=index, qn_b0=1.0)
    return jf, tf


def _step_from(jf, tf, js):
    """One step of each package from the JAX state ``js``."""
    ts = convert.fused_eig_tr_state(fields_of(js), device="cpu")
    return jf._step_jit(js), tf._step(ts)


@pytest.mark.parametrize("case", ["accept-start", "accept-two-in",
                                  "reject"])
def test_one_step_matches_jax(case):
    if case == "reject":
        jf, tf = _solvers(quartic=50.0, extra={"tr_init_size": 2.0,
                                               "tr_max_size": 4.0})
    else:
        jf, tf = _solvers()
    js = jf._state0
    if case == "accept-two-in":
        js = jf._step_jit(jf._step_jit(js))
        assert float(js.z0) != 0.0 and int(js.qn.count) > 0
    j1, t1 = _step_from(jf, tf, js)
    accepted = float(j1.rho) >= jf._to.eta
    assert accepted == (case != "reject")
    assert_fields_close(t1, j1, rtol=1e-9, atol=1e-12)
    assert_close(t1.eig.M, j1.eig.M, rtol=1e-12)
    assert_close(t1.eig.h, j1.eig.h, rtol=1e-12)
    assert int(t1.k) == int(j1.k) and int(t1.subiters) == int(j1.subiters)
    if case == "reject":
        assert torch.equal(t1.xk, convert.to_tensor(np.asarray(js.xk),
                                                    device="cpu"))


_FREQ_OPTS = {"tr_output_file": None, "output_file": None,
              "tr_max_iterations": 6, "tr_init_size": 0.05,
              "tr_max_size": 0.2, "tr_min_size": 1e-6, "abs_res_tol": 1e-8,
              "tr_l1_tol": 1e-4, "tr_linfty_tol": 1e-4,
              "tr_adaptive_gamma_update": True, "penalty_gamma": 10.0,
              "dtype": "float64"}


_MODELS = {}


def _freq(pkg):
    """The 2-D 8x4 frequency model of each package, built once per module
    (JAX compiles its eigensolve per model)."""
    if pkg not in _MODELS:
        kw = dict(N=3, cg_iters=25, solver="mgcg", lobpcg_iters=50)
        _MODELS[pkg] = (JFreq(8, 4, dtype=jnp.float64, **kw) if pkg == "jax"
                        else TFreq(8, 4, dtype=F64, device="cpu", **kw))
    return _MODELS[pkg]


@pytest.mark.parametrize("mode", ["linear", "quadratic"])
def test_solve_matches_jax(mode):
    jres, jst = _freq("jax").build_fused_tr(dict(_FREQ_OPTS),
                                            eig_row_model=mode).solve()
    tp = _freq("torch")
    solver = tp.build_fused_tr(dict(_FREQ_OPTS), eig_row_model=mode)
    reads0 = solver.syncs.count
    start = len(tp.lobpcg_iters_log)
    tres, tst = solver.solve()
    assert (tres["niter"], tres["subiters"]) == (jres["niter"],
                                                 jres["subiters"])
    np.testing.assert_allclose(tres["fobj"], jres["fobj"], rtol=1e-9)
    np.testing.assert_allclose(tres["x"].numpy(), np.asarray(jres["x"]),
                               rtol=0.0, atol=1e-7)
    assert tres["fobj"] < 0.9
    # the warm-start basis rides the state
    assert tst.V is not None and tst.V.shape == (tp.fem.ndof, 3)
    # one converged read per outer iteration, one exit read per LOBPCG
    # block iteration, and the inner solves' reads
    solves = tp.lobpcg_iters_log[start:]
    assert len(solves) == tres["niter"]
    assert solver.syncs.count - reads0 >= tres["niter"] + sum(solves) \
        + tres["subiters"]


class _NaNBeyond(TTiny):
    """A trial with x[0] > 0.3 evaluates to NaN."""

    def eval_full(self, x):
        out = list(super().eval_full(x))
        bad = x[0] > 0.3
        out[0] = torch.where(bad, float("nan"), out[0])
        return tuple(out)


def test_non_finite_trial_is_rejected_and_shrinks_the_radius():
    tf = tef.FusedEigenTR(_NaNBeyond(n=8, N=2, seed=2), dict(_opts()),
                          index=1, qn_b0=1.0)
    s0 = tf._state0
    s1 = tf._step(s0)
    assert float(s1.rho) == -float("inf")
    assert torch.equal(s1.xk, s0.xk) and torch.equal(s1.fk, s0.fk)
    assert int(s1.qn.count) == 0          # the pair never reaches the QN
    assert float(s1.tr_size) == max(0.25 * float(s0.tr_size),
                                    tf._to.tr_min)


def test_write_output_cadence_and_unported_paths(tmp_path):
    calls = []

    class Recorded(TTiny):
        def write_output(self, it, x):
            calls.append(it)

    tf = tef.FusedEigenTR(Recorded(n=8, N=2, seed=2),
                          dict(_opts({"tr_max_iterations": 7,
                                      "tr_write_output_frequency": 3,
                                      "tr_l1_tol": 0.0,
                                      "tr_linfty_tol": 0.0})),
                          index=1, qn_b0=1.0)
    res, state = tf.solve()
    assert res["niter"] == 7 and calls == [1, 3, 6]
    assert set(res) == {"x", "fobj", "converged", "niter", "infeas", "l1",
                        "linfty", "tr_size", "subiters"}
    # resumes from a final state
    tf._to = tf._to._replace(max_iterations=2)
    res2, _ = tf.solve(state0=state)
    assert res2["niter"] == 9
    with pytest.raises(NotImplementedError, match="chunked"):
        tf.solve(chunk=2)
    # checkpoints and solve_batched are ported (tests/
    # test_torch_checkpoint.py and tests/test_torch_eig_batched.py hold
    # them): the full state at the cadence, and two starts at once
    ckpt = str(tmp_path / "state.pt")
    _, st2 = tf.solve(state0=state, checkpoint_path=ckpt)
    from paropt_torch.utils.checkpoint import restore_state
    assert int(restore_state(ckpt, st2).k) == 9
    resb, stb = tf.solve_batched(torch.stack([tf._state0.xk] * 2))
    assert resb["niter"].tolist() == [2, 2] and stb.xk.shape == (2, 8)
    with pytest.raises(NotImplementedError, match="chunked"):
        tf.solve_batched(torch.zeros((2, 8), dtype=F64), chunk=2)
    with pytest.raises(ValueError, match="eig_row_model"):
        tef.FusedEigenTR(TTiny(), dict(_opts()), eig_row_model="cubic")
    # the warm-start opt-in is explicit: no V0 parameter, no basis
    assert tf._state0.V is None
    assert tef._wants_warm_start(_freq("torch"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert not tef._wants_warm_start(TTiny())


def test_state_converts_with_its_basis():
    """A JAX frequency-model state (with its warm-start basis V) converts
    whole: the eigen model, the QN state and V."""
    jf = _freq("jax").build_fused_tr(dict(_FREQ_OPTS, tr_max_iterations=1))
    js = jf._state0
    ts = convert.fused_eig_tr_state(fields_of(js), device="cpu")
    assert isinstance(ts.eig, tef.EigModel)
    assert_fields_close(ts, js, rtol=0.0)
    assert_close(ts.eig.Minv, js.eig.Minv, rtol=0.0)
    assert_close(ts.V, js.V, rtol=0.0)
    assert dataclasses.is_dataclass(ts.qn)
