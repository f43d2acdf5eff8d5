"""The fused MMA outer loop: paropt_torch.mma against paropt_tpu.mma on the
same problems and the same numpy inputs, in float64.

- The inner solve: `FusedIP` with a diagonal Hessian and no line search on
  the MMA subproblem model, stepped side by side with JAX's from the same
  start, on nwcon = 0 (layout 'gather', Aw_cols None) and on a 'blocked'
  layout with k = 3; fobj, res_norm and mu agree to 1e-10 relative on every
  step (res_norm also to 1e-13 absolute, its roundoff floor near
  convergence), free-running and re-anchored (the port stepping JAX's
  state).  Measured: fobj to 3e-16, res_norm to 2.3e-16 absolute.
- One outer iteration (`_fused_mma_step`) from a JAX state converted with
  `convert.fused_mma_state`: L, U, x after the inner solve, l1, linf and
  infeas to 1e-10.
- Free-running trajectories on the 2-D FEM (12x6, mgcg), its region-capped
  form (8x4) and DMO (12x6): the same outer and inner iteration counts,
  fobj within 1e-8 relative on every outer iteration and final x within
  1e-7 (measured: fobj to 3e-12, x to 6e-11 on DMO, 1e-13 elsewhere).
- One state solve per outer iteration on the 2-D and 3-D multigrid
  cantilevers (the gradient reuses the evaluation's state), with iterates
  bit for bit those of runs whose gradients solve again; the same on a
  one-rank strip view, whose gradients solve again.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paropt_tpu import ip_fused as jip
from paropt_tpu import mma as jmma
from paropt_tpu.models.fem_topology import DMOFEMTopology as JDMO
from paropt_tpu.models.fem_topology import FEMTopology as JFEM
from paropt_tpu.models.topology import SyntheticTopology as JTopology
from paropt_tpu.ops.kkt import ProblemData as JProblemData
from paropt_torch import convert
from paropt_torch import ip_fused as tip
from paropt_torch import mma as tmma
from paropt_torch.models.fem_topology import DMOFEMTopology as TDMO
from paropt_torch.models.fem_topology3d import FEMTopology3D
from paropt_torch.models.fem_topology import FEMTopology as TFEM
from paropt_torch.models.topology import SyntheticTopology as TTopology

from . import _torch_state_memo as state_memo
from ._torch_parity import assert_close, assert_rel, fields_of

torch.set_num_threads(1)

F64 = torch.float64
OPTS = {"mma_output_file": None}



# ---------------------------------------------------------------------------
# the inner solve: diag-Hessian FusedIP on the MMA subproblem
# ---------------------------------------------------------------------------


def _subproblem(layout, seed=0):
    """numpy MMAParams and ProblemData fields of one MMA subproblem about a
    random x0 (the outer step's formulas), with ncon = 1 and either no
    sparse constraints or 32 per-block 'sum <= 1' rows of k = 3."""
    rng = np.random.default_rng(seed)
    n, ncon = 96, 1
    x0 = rng.uniform(0.05, 0.3, n)
    L = x0 - rng.uniform(0.1, 0.3, n)
    U = x0 + rng.uniform(0.1, 0.3, n)
    g = rng.standard_normal(n)
    A = rng.standard_normal((ncon, n))
    cons = np.full(ncon, 0.05)
    eps, delta = 1e-5, 1e-3
    gp, gm = np.maximum(g, 0), np.maximum(-g, 0)
    p0 = (U - x0) ** 2 * ((1 + delta) * gp + delta * gm + eps / (U - L))
    q0 = (x0 - L) ** 2 * ((1 + delta) * gm + delta * gp + eps / (U - L))
    pi = (U - x0)[None] ** 2 * np.maximum(-A, 0)
    qi = (x0 - L)[None] ** 2 * np.maximum(A, 0)
    b = -(cons + np.sum(pi / (U - x0) + qi / (x0 - L), axis=1))
    if layout == "blocked":
        nwcon = n // 3
        cols = np.arange(n, dtype=np.int32).reshape(nwcon, 3)
        vals = -np.ones((nwcon, 3))
        cwk = 1.0 - x0.reshape(nwcon, 3).sum(axis=1)
    else:
        nwcon, cols, vals, cwk = 0, None, None, np.zeros(0)
    params = dict(L=L, U=U, p0=p0, q0=q0, pi=pi, qi=qi, b=b, cons=cons, A=A,
                  x0=x0, cwk=cwk, Aw_cols=cols, Aw_vals=vals)
    data = dict(
        g=np.zeros(n), A=np.zeros((ncon, n)), c=np.zeros(ncon),
        cw=np.zeros(nwcon),
        lb=np.maximum(0.9 * L + 0.1 * x0, x0 - 0.1),
        ub=np.minimum(0.9 * U + 0.1 * x0, x0 + 0.1),
        lb_mask=np.ones(n), ub_mask=np.ones(n), gamma_s=np.zeros(ncon),
        gamma_t=np.full(ncon, 1e3), gamma_sw=np.zeros(nwcon),
        gamma_tw=np.full(nwcon, 1e3), Aw_cols=cols, Aw_vals=vals,
        nwblock=1, Aw_layout=layout)
    return params, data, x0


def _inner_solvers(layout):
    params, data, x0 = _subproblem(layout)
    has_sparse = layout == "blocked"
    opts = dict(use_diag_hessian=True, use_line_search=False)
    n, ncon, nwcon = x0.shape[0], 1, data["cw"].shape[0]
    jf = jip.FusedIP(jmma.make_mma_model(True, has_sparse), n, ncon, nwcon,
                     1, jip.FusedIPOptions(**opts), dtype=jnp.float64)
    tf = tip.FusedIP(tmma.make_mma_model(True, has_sparse), n, ncon, nwcon,
                     1, tip.FusedIPOptions(**opts), dtype=F64)
    jp = jmma.MMAParams(**{k: None if v is None else jnp.asarray(v)
                           for k, v in params.items()})
    tp = tmma.MMAParams(**{k: None if v is None
                           else convert.to_tensor(v, device="cpu")
                           for k, v in params.items()})
    if has_sparse:
        tp = tp._replace(Aw_cols=tp.Aw_cols.long())
    jd = JProblemData(**{k: v if k in ("nwblock", "Aw_layout") or v is None
                         else jnp.asarray(v) for k, v in data.items()})
    td = convert.problem_data(data, device="cpu")
    js = jf.init(jnp.asarray(x0), jd, jp, None, None)
    ts = tf.init(torch.as_tensor(x0), td, tp, None, None)
    return jf, jd, jp, js, tf, td, tp, ts


def _scalars(st):
    return np.array([float(st.fobj), float(st.res_norm), float(st.mu)])


def _assert_scalars_close(got, want, name):
    """fobj and mu to 1e-10 relative; res_norm to 1e-10 relative plus its
    roundoff floor: near convergence it is ~1e-7 made of terms up to the
    elastic penalty (1e3), whose roundoff is ~1e-13 absolute."""
    assert_close(got[[0, 2]], want[[0, 2]], rtol=1e-10,
                 name=f"{name}: fobj, mu")
    assert_close(got[1], want[1], rtol=1e-10, atol=1e-13,
                 name=f"{name}: res_norm")


@pytest.mark.parametrize("layout", ["gather", "blocked"])
def test_diag_hessian_inner_solve_side_by_side(layout):
    """The MMA inner solve's configuration of the fused IP (diagonal
    Hessian from the model, no line search), on nwcon = 0 and on the
    'blocked' layout with k = 3: every step, free-running and re-anchored,
    to 1e-10 relative, to the same converged iteration and x."""
    jf, jd, jp, js, tf, td, tp, ts = _inner_solvers(layout)
    assert (td.Aw_cols is None) == (layout == "gather")
    assert_close(_scalars(ts), _scalars(js), rtol=1e-12, name="init")
    for i in range(100):
        anchor = tf.step(convert.fused_state(fields_of(js),
                                             device="cpu"), td, tp, None)
        js = jf.step(js, jd, jp, None)
        ts = tf.step(ts, td, tp, None)
        _assert_scalars_close(_scalars(ts), _scalars(js), f"step {i}")
        _assert_scalars_close(_scalars(anchor), _scalars(js),
                              f"anchored step {i}")
        if bool(js.converged) and bool(ts.converged):
            break
    assert bool(js.converged) and bool(ts.converged)
    assert int(ts.k) == int(js.k) and float(ts.res_norm) < 1e-6
    assert_rel(ts.vars.x, js.vars.x, rtol=1e-10)
    assert_rel(ts.vars.z, js.vars.z, rtol=1e-10)


# ---------------------------------------------------------------------------
# the outer loop
# ---------------------------------------------------------------------------


PROBLEMS = {
    "fem12x6-mgcg": (lambda: JFEM(12, 6, cg_iters=25, solver="mgcg"),
                     lambda: TFEM(12, 6, cg_iters=25, solver="mgcg",
                                  dtype=F64, device="cpu"), 15),
    "regions8x4": (lambda: JFEM(8, 4, region=4, region_cap=0.7,
                                cg_iters=250),
                   lambda: TFEM(8, 4, region=4, region_cap=0.7, cg_iters=250,
                                dtype=F64, device="cpu"), 15),
    "dmo12x6": (lambda: JDMO(12, 6, cg_iters=120),
                lambda: TDMO(12, 6, cg_iters=120, dtype=F64,
                             device="cpu"), 15),
}


def _mma_pair(name, **options):
    jmake, tmake, iters = PROBLEMS[name]
    opts = dict(OPTS, mma_max_iterations=iters)
    opts.update(options)
    return jmma.FusedMMA(jmake(), dict(opts)), tmma.FusedMMA(tmake(),
                                                             dict(opts))


@pytest.fixture(scope="module", params=sorted(PROBLEMS))
def trajectory(request):
    """Both packages' outer loops stepped side by side to the cap."""
    jm, tm = _mma_pair(request.param)
    js, ts = jm._state0, tm._state0
    steps = []
    for _ in range(jm._mo.max_iterations):
        js = jm._step_jit(js)
        ts = tm._step(ts)
        steps.append((float(js.fobj), float(ts.fobj), int(js.k), int(ts.k),
                      int(js.subiters), int(ts.subiters)))
        if bool(js.converged) and bool(ts.converged):
            break
    return dict(name=request.param, jm=jm, tm=tm, js=js, ts=ts, steps=steps)


def test_outer_trajectory_fobj_and_counts(trajectory):
    """The same outer and inner iteration counts after every outer
    iteration, and fobj within 1e-8 relative."""
    for i, (jf, tf, jk, tk, jsub, tsub) in enumerate(trajectory["steps"]):
        assert tk == jk and tsub == jsub, (i, jk, tk, jsub, tsub)
        assert tf == pytest.approx(jf, rel=1e-8), i
    assert int(trajectory["ts"].subiters) > 0


def test_outer_trajectory_final_state(trajectory):
    js, ts = trajectory["js"], trajectory["ts"]
    assert_close(ts.x, js.x, rtol=0, atol=1e-7)
    for name in ("L", "U", "infeas", "l1", "linf"):
        assert_rel(getattr(ts, name), getattr(js, name), rtol=1e-6,
                   name=name)
    assert bool(ts.converged) == bool(js.converged)
    assert ts.k.dtype == ts.subiters.dtype == torch.int32


def test_solve_matches_stepping_and_jax():
    """`FusedMMA.solve` runs the stepped loop: its result dict (with the
    final re-evaluated fobj) equals JAX's."""
    jm, tm = _mma_pair("fem12x6-mgcg", mma_max_iterations=6)
    jres, _ = jm.solve(jit_loop=False)
    tres, tst = tm.solve()
    assert tres["niter"] == jres["niter"] == 6
    assert tres["fobj"] == pytest.approx(jres["fobj"], rel=1e-8)
    for key in ("infeas", "l1", "linfty"):
        assert tres[key] == pytest.approx(jres[key], rel=1e-6, abs=1e-12)
    assert tres["converged"] is jres["converged"] is False
    assert_close(tres["x"], jres["x"], rtol=0, atol=1e-7)
    # one host read per outer iteration plus one per inner step
    assert tm.syncs.count >= 2 * tres["niter"] + int(tst.subiters)


@pytest.mark.parametrize("presteps", [1, 3])
def test_one_outer_step_from_converted_state(presteps):
    """One `_fused_mma_step` of each package from the same JAX state
    (`convert.fused_mma_state`): L, U, x after the inner solve, l1, linf and
    infeas to 1e-10.  presteps 1 takes the initial asymptotes, 3 the
    contract/relax update."""
    jm, tm = _mma_pair("fem12x6-mgcg")
    js = jm._state0
    for _ in range(presteps):
        js = jm._step_jit(js)
    ts = convert.fused_mma_state(fields_of(js), device="cpu")
    assert ts.k.dtype == torch.int32 and ts.converged.dtype == torch.bool
    js1, ts1 = jm._step_jit(js), tm._step(ts)
    for name in ("L", "U", "x", "l1", "linf", "infeas", "fobj", "z", "zl",
                 "zu"):
        assert_rel(getattr(ts1, name), getattr(js1, name), rtol=1e-10,
                   name=name)
    assert int(ts1.k) == int(js1.k) == presteps + 1
    assert int(ts1.subiters) == int(js1.subiters)


def test_asymptote_factor_keeps_the_dtype():
    """The contract/relax factor is built from a tensor operand: with two
    Python scalars (`torch.where(indc < 0, 0.7, 1.2)`, the JAX line's
    shape) torch returns float32 and the f64 asymptotes drift by 1e-8."""
    mo = tmma.FusedMMAOptions()
    indc = torch.tensor([-1.0, 0.0, 2.0], dtype=F64)
    fac = tmma._asymptote_factor(indc, mo)
    assert fac.dtype == F64
    assert fac.tolist() == [0.7, 1.2, 1.2]
    # and through a solve: every float field of the state stays f64 and
    # the counters int32
    _, tm = _mma_pair("regions8x4", mma_max_iterations=3)
    _, st = tm.solve()
    for name in ("x", "L", "U", "fobj", "l1", "linf", "infeas", "best_l1"):
        assert getattr(st, name).dtype == F64, name
    for name in ("k", "subiters", "no_improve"):
        assert getattr(st, name).dtype == torch.int32, name


def test_f32_stall_criterion_terminates():
    """Mirror of tests/test_mma.py's f32 stall test: in float32 the outer
    loop stops at its noise floor through mma_max_no_improvement, converged
    and stalled, feasible and stationary relative to ||g||_1."""
    opts = dict(OPTS, mma_max_iterations=150, dtype="float32",
                mma_max_no_improvement=10)
    prob = TTopology(n=4096, block=8, dtype=torch.float32, device="cpu")
    r, _ = tmma.FusedMMA(prob, dict(opts)).solve()
    assert r["converged"] and r["stalled"], r
    assert r["niter"] < 150
    assert r["infeas"] < 1e-5
    g, _ = prob.eval_obj_con_gradient(r["x"])
    assert r["l1"] < 1e-2 * float(torch.sum(torch.abs(g)))


def test_converged_loop_skips_the_inner_solve():
    """SyntheticTopology (blocked_t) through the no-improvement exit, as
    JAX; once converged, a further outer step leaves x and the multipliers
    as they were and adds no inner iterations (JAX's lax.cond skip)."""
    opts = dict(OPTS, mma_max_iterations=60, mma_max_no_improvement=5)
    tm = tmma.FusedMMA(TTopology(n=256, block=8, dtype=F64,
                                 device="cpu"), dict(opts))
    jm = jmma.FusedMMA(JTopology(n=256, block=8), dict(opts))
    tres, ts = tm.solve()
    jres, js = jm.solve(jit_loop=False)
    assert tres["converged"] and jres["converged"]
    assert tres["stalled"] and jres["stalled"]
    assert tres["niter"] == jres["niter"] < 60
    assert int(ts.subiters) == int(js.subiters)
    assert tres["fobj"] == pytest.approx(jres["fobj"], rel=1e-8)
    again = tm._step(ts)
    for name in ("x", "z", "zw", "zl", "zu", "x1", "x2"):
        assert torch.equal(getattr(again, name), getattr(ts, name)), name
    assert int(again.k) == int(ts.k)
    assert int(again.subiters) == int(ts.subiters)


def test_write_output_cadence_and_unported_paths(tmp_path):
    calls = []

    class Recorded(TFEM):
        def write_output(self, it, x):
            calls.append(it)

    prob = Recorded(8, 4, cg_iters=250, dtype=F64, device="cpu")
    solver = tmma.FusedMMA(prob, dict(OPTS, mma_max_iterations=12,
                                      write_output_frequency=5))
    # the per-step loop (jit_loop=False) fires after every outer iteration
    solver.solve(jit_loop=False)
    assert calls == [1, 5, 10]
    # the chunked loop fires at its window boundaries (3, 6, 9, 12)
    calls.clear()
    solver.solve(chunk=3)
    assert calls == [3, 6, 12]
    # checkpoints are ported: the full state at the same cadence
    ckpt = str(tmp_path / "state.pt")
    _, state = solver.solve(jit_loop=False, checkpoint_path=ckpt)
    from paropt_torch.utils.checkpoint import restore_state
    assert int(restore_state(ckpt, state).k) == 10
    # solve_batched and its chunked form are ported
    # (tests/test_torch_chunked_batched.py)
    # the base class's no-op write_output costs no hook
    from paropt_torch.utils.chunked import user_write_output
    assert user_write_output(TFEM(8, 4, cg_iters=10, dtype=F64,
                                  device="cpu")) is None
    assert user_write_output(prob) is not None


def test_fused_mma_solve_reuses_the_build():
    prob = TFEM(8, 4, cg_iters=250, dtype=F64, device="cpu")
    opts = dict(OPTS, mma_max_iterations=3)
    r1, _ = tmma.fused_mma_solve(prob, dict(opts))
    n_solvers = len(tmma._FUSED_MMA_CACHE)
    r2, _ = tmma.fused_mma_solve(prob, dict(opts))
    assert len(tmma._FUSED_MMA_CACHE) == n_solvers
    assert torch.equal(r1["x"], r2["x"])


# ---------------------------------------------------------------------------
# one state solve per outer iteration (the models' state memo)
# ---------------------------------------------------------------------------

MEMO_MMA = {
    "fem12x6-mgcg": lambda dt: TFEM(12, 6, cg_iters=25, solver="mgcg",
                                    dtype=dt, device="cpu"),
    "fem3d8x4x4-mgcg": lambda dt: FEMTopology3D(8, 4, 4, cg_iters=10,
                                                solver="mgcg", dtype=dt,
                                                device="cpu"),
}
MEMO_MMA_CASES = [(name, dt) for name in sorted(MEMO_MMA)
                  for dt in (torch.float32, F64)]


def _memo_steps(prob, steps=5):
    """The iterates of ``steps`` FusedMMA outer iterations, and the state
    solves they ran."""
    solves = state_memo.Solves(prob)
    solver = tmma.FusedMMA(prob, dict(OPTS, mma_max_iterations=steps,
                                      dtype=str(prob._dtype)[6:]))
    st, xs = solver._state0, []
    for _ in range(steps):
        st = solver._step(st)
        xs.append(st.x)
    assert int(st.k) == steps and not bool(st.converged)
    return xs, solves.n


@pytest.mark.parametrize("name,dt", MEMO_MMA_CASES,
                         ids=[f"{n}-{str(d)[6:]}" for n, d in MEMO_MMA_CASES])
def test_one_state_solve_per_outer_iteration(name, dt):
    """FusedMMA runs one state solve per outer iteration: the gradient
    reuses the evaluation's state.  Its iterates equal bit for bit those of
    the same run with every gradient handed a clone of x, which solves
    again."""
    xs, n = _memo_steps(MEMO_MMA[name](dt))
    assert n == 5
    miss = MEMO_MMA[name](dt)
    gradient = miss.eval_obj_con_gradient
    miss.eval_obj_con_gradient = lambda x: gradient(x.clone())
    xs_miss, n_miss = _memo_steps(miss)
    assert n_miss == 10
    for k, (x, x_miss) in enumerate(zip(xs, xs_miss)):
        assert torch.equal(x, x_miss), k


def test_state_memo_on_a_one_rank_strip_view(tmp_path):
    """FusedMMA from a sharded state at one rank: the strip view starts
    with no memo, gets a local tensor at each call (so its gradients solve
    again), and its iterates equal the plain model's bit for bit."""
    import torch.distributed as dist
    from paropt_torch.models.fem_topology3d import _FEM3DStrip
    from paropt_torch.parallel import sharding as sh
    make = MEMO_MMA["fem3d8x4x4-mgcg"]
    opts = dict(OPTS, mma_max_iterations=5, dtype="float64")
    res, st = tmma.FusedMMA(make(F64), dict(opts)).solve()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        mesh = sh.design_mesh("cpu")
        prob = make(F64)
        prob.eval_obj_con(prob.get_vars_and_bounds()[0])
        assert prob._memo is not None
        assert prob._strip_view(mesh)._memo is None
        solver = tmma.FusedMMA(prob, dict(opts))
        solves = []
        solve = _FEM3DStrip._solve
        _FEM3DStrip._solve = lambda self, E: solves.append(1) or solve(
            self, E)
        try:
            res_s, st_s = solver.solve(
                state0=sh.shard_tree(solver._state0, mesh, prob.nvars))
        finally:
            _FEM3DStrip._solve = solve
    finally:
        dist.destroy_process_group()
    # two per outer iteration and the final evaluation
    assert len(solves) == 11
    assert int(st_s.k) == int(st.k) == 5
    assert torch.equal(st_s.x.full_tensor(), st.x)
    assert res_s["fobj"] == res["fobj"]
