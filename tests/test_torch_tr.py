"""The fused SL1QP trust region: paropt_torch.tr against paropt_tpu.tr on the
same problems and the same numpy inputs, in float64.

- Free-running trajectories, both packages stepped side by side: the same
  outer and inner iteration counts after every outer iteration, fobj to
  1e-10 relative, final x to 1e-9.  Cases: SyntheticTopology(256) for 20
  iterations, SyntheticTopology(512) to convergence, the 2-D FEM (12x6,
  mgcg) for 15, Sellar (ncon = 2) with L-SR1 and the
  'subproblem_objective' steering model, Maratos (one equality),
  SparseRosenbrock (a 'gather' sparse row, ncon = 0) and Toy with the
  adaptive penalties off.
- One outer iteration (`_fused_tr_step`) of each package from the same
  mid-trajectory JAX state (`convert.fused_tr_state`): every state field,
  the QN state's included, to 1e-12 relative.
- The non-finite fail-stop, the registry -> inner-options mapping, which
  kernel route each inner solve takes, TF32 turned off, the write-output
  cadence, the unported entry points and the QP model's eigen row.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paropt_tpu import tr as jtr
from paropt_tpu.models import analytic as ja
from paropt_tpu.models.fem_topology import FEMTopology as JFEM
from paropt_tpu.models.topology import SyntheticTopology as JTopology
from paropt_tpu.problem import Problem as JProblem
from paropt_tpu.utils.options import make_options as jmake_options
from paropt_torch import convert
from paropt_torch import tr as ttr
from paropt_torch.models import analytic as ta
from paropt_torch.models.fem_topology import FEMTopology as TFEM
from paropt_torch.models.topology import SyntheticTopology as TTopology
from paropt_torch.ops import kernels
from paropt_torch.ops import qn as tqn
from paropt_torch.problem import Problem as TProblem
from paropt_torch.utils.options import make_options as tmake_options

from ._torch_parity import assert_close, fields_of

torch.set_num_threads(1)

F64 = torch.float64
BASE = {"tr_output_file": None, "output_file": None}
SYN = dict(BASE, abs_res_tol=1e-8, tr_infeas_tol=1e-5, tr_l1_tol=1e-6,
           tr_linfty_tol=1e-6)


class _TBowl(TProblem):
    """Quadratic pulling toward x = 1.6 with a -0.01 log(1.3 - max(x))
    term: any trial beyond 1.3 evaluates to NaN (tests/test_tr.py)."""

    def __init__(self):
        super().__init__(nvars=4, ncon=0)

    def objective(self, x):
        return torch.sum((x - 1.6) ** 2) - 0.01 * torch.log(1.3 - torch.max(x))

    def get_vars_and_bounds(self):
        kw = dict(dtype=F64)
        return (torch.full((4,), 0.5, **kw), torch.full((4,), -2.0, **kw),
                torch.full((4,), 2.0, **kw))


class _JBowl(JProblem):
    """`_TBowl` in JAX."""

    def __init__(self):
        super().__init__(nvars=4, ncon=0)

    def objective(self, x):
        return jnp.sum((x - 1.6) ** 2) - 0.01 * jnp.log(1.3 - jnp.max(x))

    def get_vars_and_bounds(self):
        return jnp.full(4, 0.5), jnp.full(4, -2.0), jnp.full(4, 2.0)


# name -> (JAX problem, port problem, options)
CASES = {
    "synthetic256": (lambda: JTopology(n=256, block=8),
                     lambda: TTopology(n=256, block=8, dtype=F64,
                                       device="cpu"),
                     dict(SYN, tr_max_iterations=20)),
    "synthetic512-converge": (
        lambda: JTopology(n=512, block=8),
        lambda: TTopology(n=512, block=8, dtype=F64, device="cpu"),
        dict(SYN, tr_max_iterations=60, tr_l1_tol=0.0, tr_linfty_tol=1e-4)),
    "fem12x6-mgcg": (
        lambda: JFEM(12, 6, cg_iters=25, solver="mgcg"),
        lambda: TFEM(12, 6, cg_iters=25, solver="mgcg", dtype=F64,
                     device="cpu"),
        dict(BASE, tr_max_iterations=15, abs_res_tol=1e-7,
             tr_infeas_tol=1e-5, tr_l1_tol=0.0, tr_linfty_tol=1e-5)),
    # L-SR1 with the steering solve's subproblem model, on two
    # constraints.  Free-running trajectories are compared only where no
    # decision sits on a roundoff edge: on SyntheticTopology the
    # 'subproblem_objective' steering solve ends on its no-improvement exit,
    # where an x differing by 4e-16 takes 10 inner iterations instead of 11
    # at outer iteration 5, and L-SR1 on Maratos and on SparseRosenbrock
    # turns on its skip test; one step from the same state agrees there
    "sellar-sr1-subproblem-objective": (
        ja.Sellar, lambda: ta.Sellar(dtype=F64, device="cpu"),
        dict(BASE, tr_max_iterations=30, abs_res_tol=1e-8, qn_type="sr1",
             tr_adaptive_objective="subproblem_objective")),
    "maratos": (ja.Maratos, lambda: ta.Maratos(dtype=F64, device="cpu"),
                dict(BASE, tr_max_iterations=15, abs_res_tol=1e-8)),
    "sparse-rosenbrock": (
        ja.SparseRosenbrock, lambda: ta.SparseRosenbrock(dtype=F64,
                                                         device="cpu"),
        dict(BASE, tr_max_iterations=15, abs_res_tol=1e-8,
             tr_init_size=0.5, tr_max_size=10.0)),
    # fixed penalties: no steering solve, no penalty update
    "toy-fixed-gamma": (ja.Toy, lambda: ta.Toy(dtype=F64, device="cpu"),
                        dict(BASE, tr_max_iterations=15, abs_res_tol=1e-8,
                             tr_adaptive_gamma_update=False)),
}


def _tr_pair(name, **extra):
    jmake, tmake, opts = CASES[name]
    opts = dict(opts, **extra)
    return jtr.FusedTR(jmake(), dict(opts)), ttr.FusedTR(tmake(), dict(opts))


_RUNS = {}


def _side_by_side(name):
    """Both packages' outer loops stepped side by side to convergence or
    the cap; the JAX states are kept for the one-step tests.  Each case
    runs once per module (a JAX solver compiles its step on first use)."""
    if name not in _RUNS:
        jf, tf = _tr_pair(name)
        js, ts = jf._state0, tf._state0
        jstates, steps = [js], []
        for _ in range(jf._to.max_iterations):
            js = jf._step_jit(js)
            ts = tf._step(ts)
            jstates.append(js)
            steps.append((float(js.fk), float(ts.fk), int(js.k), int(ts.k),
                          int(js.subiters), int(ts.subiters),
                          bool(js.converged), bool(ts.converged)))
            if bool(js.converged) and bool(ts.converged):
                break
        _RUNS[name] = dict(name=name, jf=jf, tf=tf, js=js, ts=ts,
                           jstates=jstates, steps=steps)
    return _RUNS[name]


@pytest.fixture(params=sorted(CASES))
def trajectory(request):
    return _side_by_side(request.param)


def test_trajectory_counts_and_fobj(trajectory):
    """The same outer and inner iteration counts and the same converged
    flag after every outer iteration, fobj to 1e-10 relative."""
    for i, (jfk, tfk, jk, tk, jsub, tsub, jc, tc) in enumerate(
            trajectory["steps"]):
        assert (tk, tsub, tc) == (jk, jsub, jc), (i, jk, tk, jsub, tsub)
        assert tfk == pytest.approx(jfk, rel=1e-10), i
    assert int(trajectory["ts"].subiters) > 0
    if trajectory["name"] == "synthetic512-converge":
        assert bool(trajectory["ts"].converged)


def test_trajectory_final_state(trajectory):
    js, ts = trajectory["js"], trajectory["ts"]
    assert_close(ts.xk, js.xk, rtol=0, atol=1e-9, name="x")
    for name in ("tr_size", "gamma", "infeas"):
        _assert_rel_floor(getattr(ts, name), getattr(js, name), 1e-9, name)
    for name in ("l1", "linf"):
        assert getattr(ts, name).item() == pytest.approx(
            getattr(js, name).item(), rel=1e-6, abs=1e-12), name
    assert ts.k.dtype == ts.subiters.dtype == torch.int32
    assert ts.converged.dtype == torch.bool
    for name in ("xk", "fk", "gk", "Ak", "tr_size", "gamma", "rho"):
        assert getattr(ts, name).dtype == F64, name


def _assert_rel_floor(got, want, rtol, name):
    """max |got - want| <= rtol * max(max |want|, 1): constraint values
    near an active bound are differences of O(1) terms (V - mean(x)) and
    carry their roundoff, ~1e-16 absolute."""
    got, want = np.asarray(got), np.asarray(want)
    err = float(np.max(np.abs(got - want))) if want.size else 0.0
    scale = max(float(np.max(np.abs(want))) if want.size else 0.0, 1.0)
    assert err <= rtol * scale, f"{name}: {err:.3e} > {rtol:.0e} * {scale:.3e}"


def _assert_state_close(got, want, rtol, prefix=""):
    """Every field: counters and flags equal, tensors to ``rtol`` of the
    field's largest entry (or of 1), the QN state field by field."""
    for f in dataclasses.fields(want):
        b = getattr(want, f.name)
        if f.metadata.get("static") or b is None:
            assert getattr(got, f.name) == b, f.name
            continue
        a = getattr(got, f.name)
        name = prefix + f.name
        if dataclasses.is_dataclass(b):
            _assert_state_close(a, b, rtol, prefix=name + ".")
        elif np.asarray(b).dtype.kind in "bi":
            assert np.array_equal(np.asarray(a), np.asarray(b)), name
        else:
            _assert_rel_floor(a, b, rtol, name)


@pytest.mark.parametrize("name,presteps", [
    ("synthetic256", 3), ("fem12x6-mgcg", 2),
    ("sellar-sr1-subproblem-objective", 2), ("maratos", 2)])
def test_one_outer_step_from_converted_state(name, presteps):
    """One `_fused_tr_step` of the port from JAX's mid-trajectory state
    equals JAX's next state field by field to 1e-12 (the QN ring buffer,
    its Gram matrices and b0 included)."""
    run = _side_by_side(name)
    jstates = run["jstates"]
    assert len(jstates) > presteps + 1
    ts = convert.fused_tr_state(fields_of(jstates[presteps]), device="cpu")
    assert ts.k.dtype == torch.int32 and ts.qn.count.dtype == torch.int32
    _assert_state_close(run["tf"]._step(ts), jstates[presteps + 1],
                        rtol=1e-12)


# ---------------------------------------------------------------------------
# the fail-stop, the option mapping and the kernel routes
# ---------------------------------------------------------------------------


def test_nan_trial_fail_stop():
    """A non-finite trial is rejected (never accepted even at tr_min),
    never reaches the QN state, and shrinks the radius so the loop
    recovers (tests/test_tr.py's case and assertions); the run takes JAX's
    outer and inner iterations to the same point."""
    opts = dict(BASE, tr_max_iterations=40, tr_init_size=0.5,
                tr_adaptive_gamma_update=False, abs_res_tol=1e-8,
                tr_infeas_tol=1e-5, tr_l1_tol=0.0, tr_linfty_tol=1e-5)
    r, st = ttr.FusedTR(_TBowl(), dict(opts)).solve()
    x = r["x"].numpy()
    assert np.all(np.isfinite(x)) and np.isfinite(r["fobj"])
    assert np.all(x < 1.3)                     # never accepted a NaN trial
    assert x[0] > 1.0                          # and still made progress
    assert torch.isfinite(st.gk).all() and torch.isfinite(st.qn.buf).all()
    assert r["tr_size"] < 0.5                  # the radius shrank
    rj, _ = jtr.FusedTR(_JBowl(), dict(opts)).solve()
    assert (r["niter"], r["subiters"], r["converged"]) == \
        (rj["niter"], rj["subiters"], rj["converged"])
    assert r["fobj"] == pytest.approx(rj["fobj"], rel=1e-10)
    assert_close(r["x"], rj["x"], rtol=0, atol=1e-9, name="x")


def test_inner_ip_options_mapping():
    """The registry -> FusedIPOptions mapping equals JAX's on every field
    the port has, and a non-default option reaches FusedTR's QP solver
    (tests/test_tr.py's mapping test)."""
    extra = {"max_line_iters": 7, "monotone_barrier_fraction": 0.1,
             "barrier_strategy": "complementarity_fraction",
             "tr_steering_barrier_strategy": "default",
             "tr_steering_starting_point_strategy": "default"}
    to, jo = tmake_options(dict(extra), which="facade"), \
        jmake_options(dict(extra), which="facade")
    for slm in (False, True):
        for barrier, start in ((to["barrier_strategy"],
                                to["starting_point_strategy"]),
                               (to["tr_steering_barrier_strategy"],
                                to["tr_steering_starting_point_strategy"])):
            got = ttr._fused_ip_options(to, barrier, start, slm)
            want = jtr._fused_ip_options(jo, barrier, start, slm)
            for field in got._fields:
                assert getattr(got, field) == getattr(want, field), field
    fus = ttr.FusedTR(TTopology(n=128, block=8, dtype=F64, device="cpu"),
                      dict(BASE, **extra))
    qp_opts, inf_opts = fus._step.args[3], fus._step.args[4]
    assert qp_opts.max_line_iters == inf_opts.max_line_iters == 7
    assert qp_opts.monotone_barrier_fraction == 0.1
    # 'default' steering barrier resolves to the main strategy; the
    # steering solve is a sequential linear method (B = 0), the QP is not
    assert inf_opts.barrier_strategy == "complementarity_fraction"
    assert inf_opts.starting_point_strategy == "affine_step"
    assert inf_opts.sequential_linear_method
    assert not qp_opts.sequential_linear_method
    assert not (qp_opts.use_quasi_newton_update
                or inf_opts.use_quasi_newton_update)


def test_kernel_routes_per_solve(monkeypatch):
    """On SyntheticTopology (blocked_t, nwblock = 1) every QP factor setup
    takes the fused phi_gram route (a compact QN term is present), the
    steering solve's never does (B = 0), both solve through the
    quasi-definite apply, and the outer QN update runs once per outer
    iteration, on the kernel branch exactly when the buffer is on a card."""
    calls = {"phase": None, "phi_gram": {}, "quasi_def_apply": {},
             "qn_update": [], "solves": {}}

    def counting(name, fn):
        def wrapper(*args):
            d = calls[name]
            d[calls["phase"]] = d.get(calls["phase"], 0) + 1
            return fn(*args)
        return wrapper

    for name in ("phi_gram", "quasi_def_apply"):
        monkeypatch.setattr(kernels, name,
                            counting(name, getattr(kernels, name)))
    real_loop, real_update = ttr._fused_solve_loop, tqn._qn_update

    def loop(model, opts, state, *args, **kwargs):
        phase = "steer" if opts.sequential_linear_method else "qp"
        out = real_loop(model, opts, state, *args, **kwargs)
        calls["solves"].setdefault(phase, []).append(int(out.k))
        calls["phase"] = None
        return out

    def init(model, opts, *args):
        calls["phase"] = "steer" if opts.sequential_linear_method else "qp"
        return real_init(model, opts, *args)

    def update(state, *args, kernel_branch):
        calls["qn_update"].append(kernel_branch)
        return real_update(state, *args, kernel_branch=kernel_branch)

    real_init = ttr._fused_init
    monkeypatch.setattr(ttr, "_fused_solve_loop", loop)
    monkeypatch.setattr(ttr, "_fused_init", init)
    monkeypatch.setattr(tqn, "_qn_update", update)
    fus = ttr.FusedTR(TTopology(n=256, block=8, dtype=F64, device="cpu"),
                      dict(SYN, tr_max_iterations=3))
    res, st = fus.solve()
    assert res["niter"] == 3
    assert calls["qn_update"] == [False] * 3
    # per QP solve: the affine start's factor setup, one per counted step,
    # and the converging step's (it freezes the state, so k stays)
    assert calls["phi_gram"] == {"qp": sum(k + 2 for k in
                                           calls["solves"]["qp"])}
    assert calls["quasi_def_apply"]["steer"] > 0
    assert calls["quasi_def_apply"]["qp"] > 0
    assert sum(calls["solves"]["qp"]) + sum(calls["solves"]["steer"]) == \
        res["subiters"]
    # the read of `converged` per outer iteration plus the inner reads
    # (one per step and one per line-search trial)
    assert fus.syncs.count >= res["niter"] + res["subiters"]


def test_tf32_turned_off():
    """FusedTR builds its inner solves from the step functions, not from a
    FusedIP, so it turns TF32 off itself (SyntheticTopology does not)."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        prob = TTopology(n=64, block=8, dtype=F64, device="cpu")
        assert torch.backends.cuda.matmul.allow_tf32
        ttr.FusedTR(prob, dict(BASE))
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def test_write_output_cadence_and_unported_paths(tmp_path):
    calls = []

    class Recorded(TTopology):
        def write_output(self, it, x):
            calls.append((it, x.shape))

    fus = ttr.FusedTR(Recorded(n=64, block=8, dtype=F64, device="cpu"),
                      dict(BASE, tr_max_iterations=12,
                           tr_write_output_frequency=5, tr_l1_tol=0.0,
                           tr_linfty_tol=0.0))
    res, _ = fus.solve()
    assert res["niter"] == 12
    assert calls == [(1, (64,)), (5, (64,)), (10, (64,))]
    # checkpoints are ported: the full state at the same cadence
    ckpt = str(tmp_path / "state.pt")
    _, state = fus.solve(checkpoint_path=ckpt)
    from paropt_torch.utils.checkpoint import restore_state
    assert int(restore_state(ckpt, state).k) == 10
    # solve_batched is ported; its chunked form is not
    with pytest.raises(NotImplementedError, match="chunked"):
        fus.solve_batched(torch.zeros((2, 64), dtype=F64), chunk=4)
    # the eigen row of the QP model (ported with the eigenvalue path): row
    # eig_index gets + 1/2 (h p)' M (h p) and its gradient + h' M (h p),
    # held against paropt_tpu's; without eig_index the fields are ignored
    st = fus._state0
    rng = np.random.default_rng(4)
    eig_M = -np.eye(2) + 0.1 * rng.standard_normal((2, 2))
    eig_h = rng.standard_normal((2, 64))
    p = rng.uniform(-0.1, 0.1, 64)
    fields = dict(fk=st.fk, gk=st.gk, ck=st.ck, Ak=st.Ak, cwk=st.cwk,
                  Aw_cols=None, Aw_vals=None, b0=st.fk * 0 + 0.5, Z=None,
                  M=None, obj_scale=st.fk * 0 + 1.0)
    tparams = ttr.QPParams(**fields, eig_M=torch.tensor(eig_M),
                           eig_h=torch.tensor(eig_h))
    jparams = jtr.QPParams(
        **{k: (None if v is None else jnp.asarray(v.numpy()))
           for k, v in fields.items()},
        eig_M=jnp.asarray(eig_M), eig_h=jnp.asarray(eig_h))
    for mode in ("quadratic", "linear"):
        tm = ttr.make_qp_model(False, mode, eig_index=0)
        jm = jtr.make_qp_model(False, mode, eig_index=0)
        for got, want in zip(tm.eval_obj_con(tparams, torch.tensor(p)) +
                             tm.eval_grad(tparams, torch.tensor(p)),
                             jm.eval_obj_con(jparams, jnp.asarray(p)) +
                             jm.eval_grad(jparams, jnp.asarray(p))):
            assert_close(got, want, rtol=1e-12, atol=1e-14)
        plain = ttr.make_qp_model(False, mode)
        bare = tparams._replace(eig_M=None, eig_h=None)
        for got, want in zip(plain.eval_obj_con(tparams, torch.tensor(p)),
                             plain.eval_obj_con(bare, torch.tensor(p))):
            assert torch.equal(got, want)
        _, A_eig = tm.eval_grad(tparams, torch.tensor(p))
        _, A_plain = plain.eval_grad(tparams, torch.tensor(p))
        assert torch.equal(A_plain, tparams.Ak)
        assert not torch.equal(A_eig, A_plain)


def test_solve_resumes_and_result_keys():
    """`solve` returns JAX's result keys; a final state passed back as
    state0 continues the run where it stopped."""
    _, tf = _tr_pair("synthetic256")
    tf._to = tf._to._replace(max_iterations=2)
    r1, s1 = tf.solve()
    r2, s2 = tf.solve(state0=s1)
    assert set(r1) == {"x", "fobj", "converged", "niter", "infeas", "l1",
                       "linfty", "tr_size", "subiters"}
    assert (r1["niter"], r2["niter"]) == (2, 4)
    assert r2["subiters"] > r1["subiters"]
