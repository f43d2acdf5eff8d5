"""The chunked execution of the fused solvers (`paropt_torch.utils.chunked`,
the ``jit_loop`` / ``chunk`` arguments) against paropt_tpu's
(`paropt_tpu/utils/chunked.py`), on the same numpy inputs in float64:

- `run_chunked`'s rule on a counting loop: the hook's iterations for int
  and None chunks and every start, cap and convergence count, equal to
  JAX's `run_chunked` driving the same loop;
- FusedIP, FusedMMA, FusedTR and FusedEigenTR on
  tests/test_chunked_output.py's problems (SyntheticTopology(n=64,
  block=8), its TR and MMA options; tests/test_eig_fused_step.py's tiny
  eigen problem): under ``chunk`` in {1, 2, 3, None} each final state is
  within 1e-12 of paropt_tpu's (absolute, on entries of order one), niter
  is equal, and the hook's list of (k, x) is JAX's (k equal, x within
  1e-12); the port's chunked states equal its unchunked one bit for bit;
- FusedIP's resume: ``state0`` stops at the absolute ``max_iters`` under
  ``jit_loop=True`` and runs ``max_iters`` more under the default;
- ``'auto'`` ends where ``chunk=None`` ends, bit for bit (its window sizes
  are timed, so not compared).

The batched solves and the other solvers' resume are in
tests/test_torch_chunked_batched.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paropt_tpu import ip_fused as jip
from paropt_tpu.eig_fused import FusedEigenTR as JEig
from paropt_tpu.models.topology import SyntheticTopology as JTop
from paropt_tpu.mma import FusedMMA as JMMA
from paropt_tpu.ops import qn as jqn
from paropt_tpu.tr import FusedTR as JTR
from paropt_tpu.utils import chunked as jchunked
from paropt_torch import ip_fused as tip
from paropt_torch.eig_fused import FusedEigenTR as TEig
from paropt_torch.models.topology import SyntheticTopology as TTop
from paropt_torch.mma import FusedMMA as TMMA
from paropt_torch.ops import qn as tqn
from paropt_torch.tr import FusedTR as TTR
from paropt_torch.utils import chunked as tchunked

from ._torch_parity import np_of
from .test_eig_fused_step import TinyEigProblem as JTiny
from .test_eig_fused_step import _opts as eig_opts
from .test_torch_eig_fused import TTiny

torch.set_num_threads(1)
F64 = torch.float64
ATOL = 1e-12
CHUNKS = [1, 2, 3, None]
MMA_OPTS = {"mma_max_iterations": 10, "mma_output_file": None,
            "dtype": "float64", "write_output_frequency": 1,
            "mma_linfty_tol": 1e-12, "mma_l1_tol": 0.0}
TR_OPTS = {"tr_output_file": None, "output_file": None, "dtype": "float64",
           "tr_max_iterations": 6, "tr_init_size": 0.05, "tr_l1_tol": 0.0,
           "tr_linfty_tol": 1e-10, "abs_res_tol": 1e-10,
           "tr_write_output_frequency": 1}
EIG_OPTS = {"tr_max_iterations": 5, "tr_write_output_frequency": 1,
            "tr_l1_tol": 0.0, "tr_linfty_tol": 0.0}


# ---------------------------------------------------------------------------
# the rule on a counting loop
# ---------------------------------------------------------------------------


class _Count:
    """A loop state: count k, converged once k reaches ``at``."""

    def __init__(self, k, at):
        self.k, self.at = k, at
        self.converged = k >= at


@pytest.mark.parametrize("chunk", [1, 2, 3, 5, 64, None])
@pytest.mark.parametrize("k0,max_it,at", [(0, 10, 99), (0, 10, 7),
                                          (4, 10, 99), (4, 6, 5),
                                          (10, 10, 99), (3, 10, 3)])
def test_rule_matches_jax_on_a_counting_loop(chunk, k0, max_it, at):
    """The windows and the hook's iterations of every int and None chunk
    are JAX's, and the state stops at the absolute ``max_it`` (or at
    convergence) from any start."""
    def advance(s, k_stop):
        return _Count(min(k_stop, s.at) if not s.converged else s.k, s.at)

    jhooks, thooks, calls = [], [], []
    jend = jchunked.run_chunked(advance, _Count(k0, at), max_it, chunk,
                                on_chunk=lambda s: jhooks.append(s.k))

    def run(s, k, k_stop):
        assert k == s.k and not s.converged and k < k_stop
        calls.append((k, k_stop))
        return advance(s, k_stop)

    tend = tchunked.run_chunked(run, _Count(k0, at), max_it, chunk,
                                on_chunk=lambda s: thooks.append(s.k))
    assert thooks == jhooks
    assert tend.k == jend.k == (min(max_it, at) if k0 < min(max_it, at)
                                else k0)
    assert all(b - a <= (chunk or max_it) for a, b in calls)


def test_rule_rejects_a_bad_chunk():
    with pytest.raises(ValueError, match="positive int"):
        tchunked.run_chunked(lambda s, k, ks: s, _Count(0, 9), 5, 0)


def test_batched_view_ends_where_an_instance_converges_first():
    """Two instances, one converged at k = 2 while the other runs: the
    port's view paces by the running instance and ends at the cap; the
    hook sees JAX's absolute windows."""
    class Batch:
        def __init__(self, k, conv):
            self.k, self.converged = torch.tensor(k), torch.tensor(conv)

    def run(s, k, k_stop):
        assert k == 4 or k == 6 or k == 8
        return Batch([2, k_stop], [True, k_stop >= 20])

    seen = []
    end = tchunked.run_chunked_batched(
        run, Batch([2, 4], [True, False]), 9, 2,
        on_chunk=lambda s: seen.append(s.k.tolist()))
    assert seen == [[2, 6], [2, 8], [2, 9]]
    assert end.k.tolist() == [2, 9]


# ---------------------------------------------------------------------------
# the four fused solvers, single solves
# ---------------------------------------------------------------------------


class _JRec(JTop):
    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.writes = []

    def write_output(self, it, x):
        self.writes.append((int(it), np.asarray(x).copy()))


class _TRec(TTop):
    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.writes = []

    def write_output(self, it, x):
        self.writes.append((int(it), x.numpy().copy()))


class _JTinyRec(JTiny):
    writes = None

    def write_output(self, it, x):
        self.writes.append((int(it), np.asarray(x).copy()))


class _TTinyRec(TTiny):
    writes = None

    def write_output(self, it, x):
        self.writes.append((int(it), x.numpy().copy()))


def _top(pkg, recording=True):
    if pkg == "jax":
        return (_JRec if recording else JTop)(n=64, block=8,
                                              dtype=jnp.float64)
    return (_TRec if recording else TTop)(n=64, block=8, dtype=F64,
                                          device="cpu")


def _tiny(pkg):
    p = (_JTinyRec if pkg == "jax" else _TTinyRec)(n=8, N=2, seed=2)
    p.writes = []
    return p


def _build(kind, pkg, extra=None):
    """(solver, problem) of one package; ``extra`` overrides options."""
    if kind == "mma":
        prob = _top(pkg)
        return (JMMA if pkg == "jax" else TMMA)(
            prob, dict(MMA_OPTS, **(extra or {}))), prob
    if kind == "tr":
        prob = _top(pkg)
        return (JTR if pkg == "jax" else TTR)(
            prob, dict(TR_OPTS, **(extra or {}))), prob
    prob = _tiny(pkg)
    cls = JEig if pkg == "jax" else TEig
    return cls(prob, dict(eig_opts(dict(EIG_OPTS, **(extra or {})))),
               index=1, qn_b0=1.0), prob


def _x(kind, state):
    return np_of(state.x if kind == "mma" else state.xk)


def _assert_states(tstate, jstate, fields):
    for f in fields:
        np.testing.assert_allclose(np_of(getattr(tstate, f)),
                                   np_of(getattr(jstate, f)), rtol=0.0,
                                   atol=ATOL, err_msg=f)


def _assert_writes(twrites, jwrites):
    assert [k for k, _ in twrites] == [k for k, _ in jwrites]
    for (_, tx), (_, jx) in zip(twrites, jwrites):
        np.testing.assert_allclose(tx, jx, rtol=0.0, atol=ATOL)


_JAX, _JAX_SOLVERS = {}, {}


def _jax_solver(kind):
    """One paropt_tpu solver per kind and module: its compiled loop serves
    every chunk (``k_stop`` is an argument) and every cap (read from its
    options at each solve)."""
    if kind not in _JAX_SOLVERS:
        _JAX_SOLVERS[kind] = _build(kind, "jax")
    return _JAX_SOLVERS[kind]


def _jax_solve(kind, chunk):
    """paropt_tpu's solve and hook list, computed once per module."""
    key = (kind, chunk)
    if key not in _JAX:
        solver, prob = _jax_solver(kind)
        prob.writes = []
        res, st = solver.solve(chunk=chunk)
        _JAX[key] = res, st, prob.writes
    return _JAX[key]


def _set_cap(solver, kind, n):
    name = "_mo" if kind == "mma" else "_to"
    setattr(solver, name, getattr(solver, name)._replace(max_iterations=n))


FIELDS = {"mma": ("x", "L", "U", "z", "zl", "zu", "fobj", "k"),
          "tr": ("xk", "fk", "ck", "gk", "tr_size", "gamma", "k",
                 "subiters"),
          "eig": ("xk", "fk", "ck", "gk", "z0", "tr_size", "gamma", "k",
                  "subiters")}
_PORT = {}


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("kind", sorted(FIELDS))
def test_outer_solvers_chunked_match_jax(kind, chunk):
    jres, jst, jwrites = _jax_solve(kind, chunk)
    solver, prob = _build(kind, "torch")
    res, st = solver.solve(chunk=chunk)
    assert res["niter"] == jres["niter"] and res["converged"] == jres[
        "converged"]
    _assert_states(st, jst, FIELDS[kind])
    _assert_writes(prob.writes, jwrites)
    # the port's windows leave the state bit for bit
    if kind not in _PORT:
        _PORT[kind] = _build(kind, "torch")[0].solve(chunk=None)[1]
    np.testing.assert_array_equal(_x(kind, st), _x(kind, _PORT[kind]))


@pytest.mark.parametrize("kind", sorted(FIELDS))
def test_auto_ends_where_one_window_ends(kind):
    solver, _ = _build(kind, "torch")
    res, st = solver.solve(chunk="auto")
    if kind not in _PORT:
        _PORT[kind] = _build(kind, "torch")[0].solve(chunk=None)[1]
    ref = _PORT[kind]
    assert int(st.k) == int(ref.k)
    np.testing.assert_array_equal(_x(kind, st), _x(kind, ref))


def _cap(kind, n):
    return {"mma": {"mma_max_iterations": n}}.get(kind,
                                                  {"tr_max_iterations": n})


def _build_cap(kind):
    return {"mma": MMA_OPTS["mma_max_iterations"],
            "tr": TR_OPTS["tr_max_iterations"]}.get(
                kind, EIG_OPTS["tr_max_iterations"])


# ---------------------------------------------------------------------------
# FusedIP: FusedIP.solve(jit_loop=True, chunk=...) and the facade
# ---------------------------------------------------------------------------


def _ip(pkg):
    # SyntheticTopology(64) takes ~160 iterations to converge: the IP
    # cases stop at the cap, which is what the windows are measured by
    opts = dict(use_quasi_newton_update=True, max_major_iters=12)
    if pkg == "jax":
        p = JTop(n=64, block=8, dtype=jnp.float64)
        f = jip.FusedIP(jip.model_from_problem(p), 64, 1, p.nwcon, 1,
                        jip.FusedIPOptions(**opts), dtype=jnp.float64)
        d, x0 = jip.data_template_from_problem(p, dtype=jnp.float64)
        return f, d, x0, jqn.qn_init(10, 64, dtype=jnp.float64)
    p = TTop(n=64, block=8, dtype=F64, device="cpu")
    f = tip.FusedIP(tip.model_from_problem(p), 64, 1, p.nwcon, 1,
                    tip.FusedIPOptions(**opts), dtype=F64)
    d, x0 = tip.data_template_from_problem(p, dtype=F64)
    return f, d, x0, tqn.qn_init(10, 64, dtype=F64, device="cpu")


IP_FIELDS = ("fobj", "res_norm", "mu", "k", "neval")


@pytest.mark.parametrize("chunk", CHUNKS)
def test_fused_ip_chunked_matches_jax(chunk):
    """jit_loop=True with an int chunk (the hook at each window) or None
    (one call, no hook): JAX's niter, state and hook list; the port's
    chunked x equals its unchunked x bit for bit."""
    jf, jd, jx0, jq = _ip("jax")
    tf, td, tx0, tq = _ip("torch")
    jw, tw = [], []
    jhook = None if chunk is None else (
        lambda s: jw.append((int(s.k), np.asarray(s.vars.x))))
    thook = None if chunk is None else (
        lambda s: tw.append((int(s.k), s.vars.x.numpy().copy())))
    js = jf.solve(jx0, jd, (), jq, None, jit_loop=True, chunk=chunk,
                  on_chunk=jhook)
    ts = tf.solve(tx0, td, (), tq, None, jit_loop=True, chunk=chunk,
                  on_chunk=thook)
    assert int(ts.k) == int(js.k) == 12
    _assert_states(ts, js, IP_FIELDS)
    np.testing.assert_allclose(ts.vars.x.numpy(), np.asarray(js.vars.x),
                               rtol=0.0, atol=1e-10)
    _assert_writes(tw, jw)
    one = tf.solve(tx0, td, (), tq, None, jit_loop=True)
    assert torch.equal(ts.vars.x, one.vars.x)


def test_fused_ip_resume_and_step_loop():
    """``state0`` with jit_loop=True stops at the absolute max_iters; the
    default (jit_loop=False) runs max_iters more, calling the hook after
    every step; both hold the uninterrupted trajectory bit for bit."""
    tf, td, tx0, tq = _ip("torch")
    s4 = tf.solve(tx0, td, (), tq, None, max_iters=4)
    assert int(s4.k) == 4
    s7 = tf.solve(tx0, td, (), tq, None, jit_loop=True, max_iters=7,
                  chunk=2, state0=s4)
    seen = []
    s11 = tf.solve(tx0, td, (), tq, None, max_iters=7, state0=s4,
                   on_chunk=lambda s: seen.append(int(s.k)))
    assert (int(s7.k), int(s11.k), seen) == (7, 11, list(range(5, 12)))
    assert torch.equal(s7.vars.x, tf.solve(tx0, td, (), tq, None,
                                           max_iters=7).vars.x)
    assert torch.equal(s11.vars.x, tf.solve(tx0, td, (), tq, None,
                                            max_iters=11).vars.x)
    # the one-call jit_loop form honors max_iters
    assert int(tf.solve(tx0, td, (), tq, None, jit_loop=True,
                        max_iters=3).k) == 3


def test_fused_ip_optimize_windows():
    """The facade's whole solve runs FusedIP.solve(jit_loop=True,
    chunk='auto') as JAX's: the hook fires at the probe's iterations 1
    and 2 and at the end (the timed windows reach the cap of 10), and a
    resumed solve stops at the absolute cap."""
    class Rec(TTop):
        def write_output(self, it, x):
            seen.append(it)

    seen = []
    opts = {"dtype": "float64", "max_major_iters": 10,
            "write_output_frequency": 1}
    res, st = tip.fused_ip_optimize(
        Rec(n=64, block=8, dtype=F64, device="cpu"), dict(opts))
    assert (res["niter"], seen[:2], seen[-1]) == (10, [1, 2], 10)
    again, st2 = tip.fused_ip_optimize(
        TTop(n=64, block=8, dtype=F64, device="cpu"), dict(opts),
        state0=st)
    assert again["niter"] == 10 and st2 is st
