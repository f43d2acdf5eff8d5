"""The Newton-Krylov (GMRES) phase: paropt_torch's host `InteriorPoint` and
fused `FusedIP` against paropt_tpu's, on the same problems and options, in
float64 on the CPU.

- Host solves with NK to convergence on RandomConvexQP(20, 2, seed 41)
  (tests/test_gmres.py's options) and on SyntheticTopology(256, block 8)
  (nk_switch_tol 1e-3, Eisenstat-Walker gamma 0.05: the sparse constraints
  and the compact QN preconditioner): the same iterations, Hessian-vector
  products and `iNK{n}` rows, fobj to 1e-10, x to 1e-8, iteration logs
  alike and GMRES trace rows alike (integer columns equal, each float
  within one unit of its printed digit).
- Rosenbrock: a free-running NK solve is not comparable step for step.  Its
  ρ update divides by the l2 infeasibility of a linear constraint, which is
  roundoff (1e-16) there, so ρ takes the value of that roundoff (JAX
  2.48e16, the port 3.61e16 at iteration 10) and the line searches part.
  JAX's GMRES solves are instead replayed by the port from JAX's state
  (`convert.load_interior_point`): the same arms and the step to 1e-10,
  for each solve that ends within the operator's three Krylov directions
  (a solve that runs past them iterates on a roundoff residual until the
  descent-gated exit happens to pass); and both free-running solves reach
  the same optimum.
- FusedIP with NK stepped beside JAX's `FusedIP.step`: `gmres_iters` equal
  on every step and x to 1e-8; one `_fused_gmres` call from a converted
  state equals JAX's to 1e-10 and points with the quasi-Newton step.
- A forced rejection (an operator with the wrong curvature on a problem
  with bounds only): the host prints `step failed` where JAX does, and the
  fused step reports the arms it ran while returning the quasi-Newton step,
  as JAX does.

JAX's `eval_hvec_product` retraces its jvp-of-grad on every call (tens of
ms each on a CPU); the JAX problems below jit it once, the same function.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paropt_tpu import ip as jip
from paropt_tpu import ip_fused as jfused
from paropt_tpu.models import analytic as ja
from paropt_tpu.models.topology import SyntheticTopology as JTopology
from paropt_tpu.ops import kkt as jkkt
from paropt_tpu.ops import qn as jqn
from paropt_torch import convert
from paropt_torch import ip as tip
from paropt_torch import ip_fused as tfused
from paropt_torch.models import analytic as ta
from paropt_torch.models.topology import SyntheticTopology as TTopology
from paropt_torch.ops import kkt as tkkt
from paropt_torch.ops import qn as tqn

from ._torch_parity import (assert_close, assert_same_ip_solve, fields_of,
                            ip_side_by_side, jax_ip_state, np_of)

torch.set_num_threads(1)

F64 = torch.float64


class _JitHvp:
    """A JAX problem whose Hessian-vector product is jitted once."""

    def eval_hvec_product(self, x, z, zw, px):
        if "_hvp" not in self.__dict__:
            self._hvp = jax.jit(super().eval_hvec_product)
        return self._hvp(x, z, zw, px)


class JQP(_JitHvp, ja.RandomConvexQP):
    pass


class JRosenbrock(_JitHvp, ja.Rosenbrock):
    pass


class JSynthetic(_JitHvp, JTopology):
    pass


QP_OPTS = {"abs_res_tol": 1e-9, "use_hvec_product": True,
           "gmres_subspace_size": 25, "nk_switch_tol": 1.0,
           "max_major_iters": 200}
ROSEN_OPTS = {"abs_res_tol": 1e-8, "use_hvec_product": True,
              "gmres_subspace_size": 20, "nk_switch_tol": 10.0}
SYN_OPTS = {"abs_res_tol": 1e-6, "max_major_iters": 60,
            "use_hvec_product": True, "gmres_subspace_size": 25,
            "eisenstat_walker_gamma": 0.05, "nk_switch_tol": 1e-3}

HOST_CASES = {
    "qp": (lambda: JQP(n=20, ncon=2, seed=41),
           lambda: ta.RandomConvexQP(n=20, ncon=2, seed=41, dtype=F64,
                                     device="cpu"), QP_OPTS),
    "synthetic256": (lambda: JSynthetic(n=256, block=8, dtype=jnp.float64),
                     lambda: TTopology(n=256, block=8, dtype=F64,
                                       device="cpu"), SYN_OPTS),
}


def gmres_rows(path):
    """The GMRES trace of a log: one entry per header ('rtol', value), arm
    row (ints, floats), final row ('final', floats) and 'step failed'."""
    rows = []
    with open(path) as fp:
        for line in fp:
            parts = line.split()
            if line.startswith("gmres nhvc"):
                rows.append(("rtol", [float(parts[-1])]))
            elif parts[:1] == ["final"]:
                rows.append(("final", [float(p) for p in parts[1:]]))
            elif parts == ["step", "failed"]:
                rows.append(("failed", []))
            elif (line.startswith("      ") and len(parts) in (4, 6)
                  and all(p.isdigit() for p in parts[:2])):
                rows.append(((int(parts[0]), int(parts[1])),
                             [float(p) for p in parts[2:]]))
    return rows


def assert_gmres_traces_alike(jpath, tpath):
    """The same GMRES rows in the same order: integer columns equal, each
    float within one unit of its printed digit (two significant digits are
    printed) or within 1e-9 of its column's largest entry in that solve
    (a residual or projection that has reached roundoff; the projections
    take the larger of their two columns, and at least 1)."""
    jr, tr = gmres_rows(jpath), gmres_rows(tpath)
    assert len(jr) == len(tr) > 0
    assert [k for k, _ in tr] == [k for k, _ in jr]
    # each solve's arm rows, padded to four columns, give its column maxima
    solves, scale = [], None
    for k, v in jr:
        if k == "rtol":
            solves.append([])
        elif isinstance(k, tuple):
            solves[-1].append(v + [0.0] * (4 - len(v)))
    solve = -1
    for i, ((k, jv), (_, tv)) in enumerate(zip(jr, tr)):
        if k == "rtol":
            solve += 1
            scale = np.max(np.abs(solves[solve]), axis=0)
            # fproj and cproj share one scale, at least 1: cproj divides by
            # the infeasibility, so once the linearized constraints hold it
            # is roundoff amplified
            scale[2:] = max(np.max(scale[2:]), 1.0)
        jv, tv = np.asarray(jv), np.asarray(tv)
        atol = 1e-9 * (scale[:jv.size] if isinstance(k, tuple)
                       else np.max(np.abs(jv), initial=0.0))
        bad = np.abs(tv - jv) > 0.1 * np.abs(jv) + atol
        assert not bad.any(), (i, k, tv, jv)


def _nk_rows(path):
    return [line for line in open(path) if "iNK" in line]


@pytest.mark.parametrize("case", sorted(HOST_CASES))
def test_host_nk_solve_matches(case, tmp_path):
    jmake, tmake, opts = HOST_CASES[case]
    opts = dict(opts, output_level=1)
    jr, tr, js, ts = ip_side_by_side(jmake(), tmake(), opts, tmp_path)
    assert tr["converged"] and jr["converged"]
    assert ts.nhvec == js.nhvec > 0
    assert_same_ip_solve(jr, tr, tmp_path)
    jnk, tnk = _nk_rows(tmp_path / "j"), _nk_rows(tmp_path / "t")
    assert [r.split()[0] for r in tnk] == [r.split()[0] for r in jnk]
    assert len(jnk) > 0
    assert_gmres_traces_alike(tmp_path / "j", tmp_path / "t")


def test_host_nk_rosenbrock_replays_every_gmres_solve():
    """Each GMRES solve of JAX's Rosenbrock NK run, replayed by the port
    from JAX's state: the same arms and Hessian-vector products, the step
    to 1e-10 (or rejected alike).  Both free-running solves converge to
    the same optimum."""
    calls = []
    orig = jip.InteriorPoint._gmres_step

    def record(self, d, mu_j, compact, rtol):
        state = jax_ip_state(self)
        p, iters = orig(self, d, mu_j, compact, rtol)
        calls.append((state, float(mu_j), rtol, p, iters))
        return p, iters

    opts = dict(ROSEN_OPTS, output_file=None)
    js = jip.InteriorPoint(JRosenbrock(), opts)
    jip.InteriorPoint._gmres_step = record
    try:
        jr = js.optimize()
    finally:
        jip.InteriorPoint._gmres_step = orig
    ts = tip.InteriorPoint(ta.Rosenbrock(dtype=F64, device="cpu"), opts)
    tr = ts.optimize()
    assert jr["converged"] and tr["converged"]
    assert_close(tr["x"], [1.0, 1.0], rtol=0, atol=1e-6)
    assert_close(tr["x"], jr["x"], rtol=0, atol=1e-8)
    assert tr["fobj"] == pytest.approx(jr["fobj"], abs=1e-14)
    assert ts.nhvec > 0
    # the Krylov space of Rosenbrock's KKT operator has n + 1 = 3 directions
    # (two x-components and the scalar): an arm past it runs on a residual
    # at roundoff, and when it stops is roundoff too
    replayed = [c for c in calls if c[4] <= 3]
    assert len(replayed) >= 8 and len(replayed) >= len(calls) - 2

    for state, mu, rtol, jp, jiters in replayed:
        tn = convert.load_interior_point(
            tip.InteriorPoint(ta.Rosenbrock(dtype=F64, device="cpu"), opts),
            state)
        reads = tn.syncs.count
        tp, titers = tn._gmres_step(tn._make_data(), tn._scalar(mu),
                                    tn._qn_compact(), rtol)
        assert titers == jiters
        if tp is not None:
            # one host read to start, one per arm (JAX: j + 4) and one for
            # the final gate
            assert tn.syncs.count - reads == titers + 2
        assert tn.nhvec == state["nhvec"] + jiters
        assert (tp is None) == (jp is None)
        if jp is not None:
            for f in dataclasses.fields(jp):
                a, b = np_of(getattr(tp, f.name)), np_of(getattr(jp, f.name))
                if b.size:
                    scale = np.max(np.abs(b))
                    assert np.max(np.abs(a - b)) <= 1e-10 * scale, f.name


QP_FUSED = dict(abs_res_tol=1e-9, max_major_iters=200,
                use_quasi_newton_update=True, use_hvec_product=True,
                gmres_subspace_size=12, nk_switch_tol=1.0)


def _fused_pair(jprob, tprob, n, ncon, msub_qn, **opts):
    jf = jfused.FusedIP(jfused.model_from_problem(jprob), n, ncon, 0, 1,
                        jfused.FusedIPOptions(**opts))
    tf = tfused.FusedIP(tfused.model_from_problem(tprob), n, ncon, 0, 1,
                        tfused.FusedIPOptions(**opts), dtype=F64)
    jd, jx0 = jfused.data_template_from_problem(jprob)
    td, tx0 = tfused.data_template_from_problem(tprob, dtype=F64)
    js = jf.init(jx0, jd, (), jqn.qn_init(msub_qn, n), None)
    ts = tf.init(tx0, td, (), tqn.qn_init(msub_qn, n, dtype=F64,
                                          device="cpu"), None)
    return jf, tf, jd, td, js, ts


@pytest.fixture(scope="module")
def fused_qp():
    """The fused QP solve with NK, stepped side by side: each step's
    gmres_iters and x, and JAX's state where the residual first drops
    below 1e-4."""
    jf, tf, jd, td, js, ts = _fused_pair(
        JQP(n=20, ncon=2, seed=41),
        ta.RandomConvexQP(n=20, ncon=2, seed=41, dtype=F64, device="cpu"),
        20, 2, 10, **QP_FUSED)
    steps, near, after_nk = [], None, None
    for _ in range(200):
        js, ts = jf.step(js, jd, (), None), tf.step(ts, td, (), None)
        steps.append((int(js.gmres_iters), int(ts.gmres_iters),
                      np.asarray(js.vars.x), np_of(ts.vars.x)))
        if near is None and float(js.res_norm) < 1e-4:
            near = js
        if after_nk is None and int(js.gmres_iters) > 0:
            after_nk = js
        if bool(js.converged) and bool(ts.converged):
            break
    return dict(jf=jf, tf=tf, jd=jd, steps=steps, near=near,
                after_nk=after_nk, js=js, ts=ts)


def test_fused_nk_steps_match(fused_qp):
    steps = fused_qp["steps"]
    assert bool(fused_qp["ts"].converged) and bool(fused_qp["js"].converged)
    assert [t for _, t, _, _ in steps] == [j for j, _, _, _ in steps]
    assert any(j > 0 for j, _, _, _ in steps), "NK never engaged"
    for i, (_, _, jx, tx) in enumerate(steps):
        np.testing.assert_allclose(tx, jx, rtol=0, atol=1e-8, err_msg=str(i))
    # one host read per step for the NK switch, one per line-search trial
    # and one for the solve's convergence check
    assert fused_qp["tf"].syncs.count >= len(steps)
    # a JAX state just after an NK step converts whole, gmres_iters too
    ja = fused_qp["after_nk"]
    conv = convert.fused_state(fields_of(ja), device="cpu")
    assert conv.gmres_iters.dtype == torch.int32
    assert int(conv.gmres_iters) == int(ja.gmres_iters) > 0


def _gmres_inputs(jfused_solver, jd, js):
    """(v, d, factor, compact, residual) of JAX's state, as the fused step
    builds them."""
    opts = jfused_solver.opts
    model = jfused_solver.model
    v = js.vars
    d2 = jfused._refresh_data(jd, js.g, js.A, js.c, js.cw)
    cq = jfused._get_compact(opts, model, js, (), None)
    f = jkkt.setup_kkt_factor(v, d2, qn_compact=cq, qn_sigma=opts.qn_sigma)
    r = jkkt.kkt_residual(v, d2, js.mu, opts.rel_bound_barrier)
    return v, d2, f, cq, r


def _port_gmres_inputs(tf, td, ts):
    opts = tf.opts
    v = ts.vars
    d2 = tfused._refresh_data(td, ts.g, ts.A, ts.c, ts.cw)
    cq = tfused._get_compact(opts, tf.model, ts, (), None)
    f = tkkt.setup_kkt_factor(v, d2, qn_compact=cq, qn_sigma=opts.qn_sigma)
    r = tkkt.kkt_residual(v, d2, ts.mu, opts.rel_bound_barrier)
    return v, d2, f, cq, r


def test_fused_gmres_from_converted_state(fused_qp):
    """One `_fused_gmres` call from JAX's state near convergence
    (tests/test_gmres.py's direction check): the step to 1e-10, the same
    arms, and cos(step, quasi-Newton step) > 0.5."""
    jf, tf, jd = fused_qp["jf"], fused_qp["tf"], fused_qp["jd"]
    js = fused_qp["near"]
    ts = convert.fused_state(fields_of(js), device="cpu")
    td = convert.problem_data(fields_of(jd), device="cpu")
    jv, jd2, jfac, jcq, jr = _gmres_inputs(jf, jd, js)
    jp, jiters = jfused._fused_gmres(jf.model, jf.opts, (), jv, jd2, jfac,
                                     jcq, jr, jnp.asarray(1e-2), js.mu)
    v, d2, f, cq, r = _port_gmres_inputs(tf, td, ts)
    tp, titers = tfused._fused_gmres(
        tf.model, tf.opts, (), v, d2, f, cq, r,
        torch.tensor(1e-2, dtype=F64), ts.mu)
    assert int(titers) == int(jiters) > 0
    for fl in dataclasses.fields(jp):
        b = np_of(getattr(jp, fl.name))
        if b.size:
            a = np_of(getattr(tp, fl.name))
            assert np.max(np.abs(a - b)) <= 1e-10 * np.max(np.abs(b)), \
                fl.name
    pq = tkkt.solve_kkt(v, d2, f, r, qn_compact=cq)
    cos = float(torch.dot(tp.x, pq.x)
                / (torch.linalg.norm(tp.x) * torch.linalg.norm(pq.x)))
    assert cos > 0.5, cos


class _WrongCurvature:
    """A Hessian-vector product of the wrong sign (-100·px): on a problem
    with bounds only, the NK step it gives ascends and the descent gate
    rejects it."""

    def eval_hvec_product(self, x, z, zw, px):
        return -100.0 * px


class JWrong(_WrongCurvature, ja.SimpleQuadratic):
    pass


class TWrong(_WrongCurvature, ta.SimpleQuadratic):
    pass


WRONG_OPTS = {"abs_res_tol": 1e-8, "use_hvec_product": True,
              "gmres_subspace_size": 10, "nk_switch_tol": 1e3,
              "eisenstat_walker_gamma": 0.05, "max_major_iters": 60,
              "output_level": 1}


def test_rejected_nk_step_host(tmp_path):
    """`_gmres_step` returns no step with the arms it ran, and the host
    prints `step failed`, where JAX does; the solves match."""
    jr, tr, js, ts = ip_side_by_side(JWrong(n=8),
                                     TWrong(n=8, dtype=F64, device="cpu"),
                                     WRONG_OPTS, tmp_path)
    text = open(tmp_path / "t").read()
    assert text.count("step failed") == \
        open(tmp_path / "j").read().count("step failed") > 0
    assert ts.nhvec == js.nhvec
    assert_same_ip_solve(jr, tr, tmp_path)
    assert_gmres_traces_alike(tmp_path / "j", tmp_path / "t")


def test_rejected_nk_step_fused_reports_its_arms():
    """A rejected fused NK step: the state reports the arms run
    (gmres_iters > 0) while the step taken is the quasi-Newton one, as in
    JAX; stepping both packages gives the same gmres_iters and x."""
    opts = dict(abs_res_tol=1e-8, max_major_iters=60,
                use_quasi_newton_update=True, use_hvec_product=True,
                gmres_subspace_size=6, nk_switch_tol=1e3,
                eisenstat_walker_gamma=0.05)
    jf, tf, jd, td, js, ts = _fused_pair(
        JWrong(n=8), TWrong(n=8, dtype=F64, device="cpu"), 8, 0, 4, **opts)
    rejected = engaged = 0
    for _ in range(12):
        v, d2, f, cq, r = _port_gmres_inputs(tf, td, ts)
        if int(ts.k) > 0:
            p, iters = tfused._fused_gmres(
                tf.model, tf.opts, (), v, d2, f, cq, r,
                torch.tensor(1e-2, dtype=F64), ts.mu)
            pq = tkkt.solve_kkt(v, d2, f, r, qn_compact=cq)
            if int(iters) > 0 and torch.equal(p.x, pq.x):
                rejected += 1
        js, ts = jf.step(js, jd, (), None), tf.step(ts, td, (), None)
        assert int(ts.gmres_iters) == int(js.gmres_iters)
        assert_close(ts.vars.x, js.vars.x, rtol=0, atol=1e-8)
        engaged += int(ts.gmres_iters) > 0
    assert rejected > 0 and engaged > 0
