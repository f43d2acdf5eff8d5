"""The slice as a whole: paropt_torch's fused interior-point solve of
SyntheticTopology (n = 4096, block 8, f64, in-loop L-BFGS msub 10) stepped
side by side with paropt_tpu's `fused.step` from the same start.

Two comparisons per step:

- free-running: each package steps its own state;
- re-anchored: the port takes one step from JAX's state of that iteration
  (through `paropt_torch.convert`), so single-step agreement is measured
  without the roundoff both trajectories accumulate.

Tolerances: fobj, res_norm and mu agree to 1e-8 relative on every step,
free-running and re-anchored.  res_norm also gets an absolute 1e-13: near
convergence it is ~1e-6 made of terms up to the multipliers' size (~500),
so its roundoff floor is ~500 ulps = 1e-13 absolute, and the free-running
Mehrotra residuals differ by up to 1.6e-14 there (1.6e-8 relative).  The
converged iteration count is the same; final x agrees to 1e-7 (measured:
4e-14 monotone, 4e-11 Mehrotra).
"""

import dataclasses
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paropt_tpu import ip_fused as jip
from paropt_tpu.models.topology import SyntheticTopology as JTopology
from paropt_tpu.ops import qn as jqn
from paropt_torch import convert
from paropt_torch import ip_fused as tip
from paropt_torch.models.topology import SyntheticTopology as TTopology
from paropt_torch.ops import qn as tqn

from ._torch_parity import assert_close, assert_fields_close, fields_of

torch.set_num_threads(1)

N = 4096
MSUB = 10
RTOL = 1e-8
RES_ATOL = 1e-13          # res_norm's roundoff floor, see above
STRATEGIES = ["monotone", "mehrotra", "complementarity_fraction"]


def _solvers(strategy, **options):
    opts = dict(dict(use_quasi_newton_update=True, barrier_strategy=strategy),
                **options)
    jp = JTopology(n=N, block=8, dtype=jnp.float64)
    tp = TTopology(n=N, block=8, dtype=torch.float64, device="cpu")
    jf = jip.FusedIP(jip.model_from_problem(jp), N, 1, jp.nwcon, 1,
                     jip.FusedIPOptions(**opts), dtype=jnp.float64)
    tf = tip.FusedIP(tip.model_from_problem(tp), N, 1, tp.nwcon, 1,
                     tip.FusedIPOptions(**opts), dtype=torch.float64)
    jd, jx0 = jip.data_template_from_problem(jp, dtype=jnp.float64)
    td, tx0 = tip.data_template_from_problem(tp, dtype=torch.float64)
    js = jf.init(jx0, jd, (), jqn.qn_init(MSUB, N, dtype=jnp.float64), None)
    ts = tf.init(tx0, td, (), tqn.qn_init(MSUB, N, dtype=torch.float64,
                                          device="cpu"),
                 None)
    return jf, jd, js, tf, td, ts


def _scalars(st):
    return np.array([float(st.fobj), float(st.res_norm), float(st.mu)])


def _assert_scalars_close(got, want, name):
    """fobj and mu to RTOL; res_norm to RTOL plus its roundoff floor."""
    assert_close(got[[0, 2]], want[[0, 2]], rtol=RTOL, name=f"{name}: fobj, mu")
    assert_close(got[1], want[1], rtol=RTOL, atol=RES_ATOL,
                 name=f"{name}: res_norm")


@pytest.fixture(scope="module", params=STRATEGIES)
def run(request):
    """Both trajectories to convergence, with the re-anchored steps."""
    jf, jd, js, tf, td, ts = _solvers(request.param)
    out = dict(strategy=request.param, init=(js, ts), free=[], anchored=[])
    for _ in range(200):
        anchor = tf.step(convert.fused_state(fields_of(js),
                                             device="cpu"), td, (), None)
        js = jf.step(js, jd, (), None)
        ts = tf.step(ts, td, (), None)
        out["free"].append((_scalars(js), _scalars(ts)))
        out["anchored"].append((_scalars(js), _scalars(anchor)))
        if bool(js.converged) and bool(ts.converged):
            break
    out["final"] = (js, ts)
    return out


def test_init_state(run):
    js, ts = run["init"]
    assert_close(ts.fobj, js.fobj, rtol=1e-13)
    assert_close(ts.vars.x, js.vars.x, rtol=0, atol=0)
    # the same arithmetic in another order: agreement to a few ulps
    for name in ("res_norm", "mu", "comp"):
        assert_close(getattr(ts, name), getattr(js, name), rtol=1e-13,
                     name=name)


def test_per_step_reanchored(run):
    """fobj, res_norm and mu of the port's step from JAX's state agree with
    JAX's step on every iteration."""
    for i, (j, t) in enumerate(run["anchored"]):
        _assert_scalars_close(t, j, name=f"step {i}")


def test_per_step_free_running(run):
    """fobj, res_norm and mu on every step of the two trajectories, each
    package stepping its own state."""
    for i, (j, t) in enumerate(run["free"]):
        _assert_scalars_close(t, j, name=f"step {i}")


def test_same_converged_iteration_count(run):
    js, ts = run["final"]
    assert bool(js.converged) and bool(ts.converged)
    assert int(ts.k) == int(js.k)
    assert float(ts.res_norm) < 1e-6


def test_final_design(run):
    js, ts = run["final"]
    assert_close(ts.vars.x, js.vars.x, rtol=0, atol=1e-7)


def test_predictor_corrector_side_by_side():
    """mehrotra_predictor_corrector: the first 100 steps side by side, free
    running and re-anchored, at the tolerances above; then the port runs on
    to convergence.  Later the line search sits on a roundoff edge (rho
    ~1e8): a relative perturbation of 1e-15 in x of JAX's own state at step
    122 turns its accepted step from 0.398 into 0, and the two packages'
    trajectories part there (JAX converges in 150 steps, the port in 148)."""
    jf, jd, js, tf, td, ts = _solvers("mehrotra_predictor_corrector")
    for i in range(100):
        anchor = tf.step(convert.fused_state(fields_of(js),
                                             device="cpu"), td, (), None)
        js = jf.step(js, jd, (), None)
        ts = tf.step(ts, td, (), None)
        _assert_scalars_close(_scalars(ts), _scalars(js), name=f"step {i}")
        _assert_scalars_close(_scalars(anchor), _scalars(js),
                              name=f"anchored step {i}")
    for _ in range(100):
        ts = tf.step(ts, td, (), None)
        if bool(ts.converged):
            break
    assert bool(ts.converged) and float(ts.res_norm) < 1e-6


@pytest.mark.parametrize("options", [
    dict(starting_point_strategy="least_squares_multipliers"),
    dict(starting_point_strategy="none"),
    dict(use_backtracking_alpha=True),
    dict(use_line_search=False),
    dict(use_quasi_newton_update=False),
    dict(use_quasi_newton_update=False, sequential_linear_method=True),
    dict(qn_sigma=0.5),
    dict(norm_type="l1"),
    dict(norm_type="l2"),
    dict(iterative_refinement_steps=0),
], ids=lambda o: "-".join(f"{k}={v}" for k, v in o.items()))
def test_option_variants_side_by_side(options):
    """The solver's other options (starts, line search, Hessian, norms,
    refinement): 25 free-running steps side by side, monotone barrier."""
    jf, jd, js, tf, td, ts = _solvers("monotone", **options)
    _assert_scalars_close(_scalars(ts), _scalars(js), name="init")
    for i in range(25):
        js = jf.step(js, jd, (), None)
        ts = tf.step(ts, td, (), None)
        _assert_scalars_close(_scalars(ts), _scalars(js), name=f"step {i}")
    assert int(ts.k) == int(js.k)
    assert_close(ts.vars.x, js.vars.x, rtol=0, atol=1e-9)


def test_one_step_from_jax_mid_trajectory_state():
    """convert.py carries JAX's whole FusedState (vars, QN history, the
    scalar state) into the port; one step of each then agrees field for
    field (the re-anchored comparison above, on every field)."""
    jf, jd, js, tf, td, _ = _solvers("monotone")
    for _ in range(12):
        js = jf.step(js, jd, (), None)
    ts = convert.fused_state(fields_of(js), device="cpu")
    assert int(ts.qn.count) == int(js.qn.count) == MSUB
    js1 = jf.step(js, jd, (), None)
    ts1 = tf.step(ts, td, (), None)
    assert_fields_close(ts1, js1, rtol=1e-9, atol=1e-12)
    assert_fields_close(ts1.qn, js1.qn, rtol=1e-9, atol=1e-12)


def test_problem_data_matches_template():
    jp = JTopology(n=256, block=8, dtype=jnp.float64)
    tp = TTopology(n=256, block=8, dtype=torch.float64, device="cpu")
    jd, _ = jip.data_template_from_problem(jp, dtype=jnp.float64)
    td, _ = tip.data_template_from_problem(tp, dtype=torch.float64)
    assert td.Aw_layout == jd.Aw_layout == "blocked_t"
    assert td.Aw_vals_t.is_contiguous() and td.Aw_vals_t.shape == (8, 32)
    assert_fields_close(td, jd, rtol=0, atol=0)
    x = np.random.default_rng(0).uniform(0.1, 0.9, 256)
    jg, jA = jp.eval_obj_con_gradient(jnp.asarray(x))
    tg, tA = tp.eval_obj_con_gradient(torch.as_tensor(x))
    assert_close(tg, jg, rtol=1e-13, atol=1e-18)
    assert_close(tA, jA, rtol=1e-13)
    assert_close(tp.sparse_constraints(torch.as_tensor(x)),
                 jp.sparse_constraints(jnp.asarray(x)), rtol=1e-13)


def test_frozen_once_converged():
    """A converged state passes through a further step unchanged, every
    field and the QN history included."""
    _, _, _, tf, td, ts = _solvers("monotone")
    for _ in range(200):
        ts = tf.step(ts, td, (), None)
        if bool(ts.converged):
            break
    again = tf.step(ts, td, (), None)
    assert_fields_close(again, ts, rtol=0, atol=0)
    assert_fields_close(again.qn, ts.qn, rtol=0, atol=0)


def test_nonfinite_step_freezes():
    """A model that turns non-finite after the start stops the solve at the
    last finite state."""
    _, _, _, tf, td, ts = _solvers("monotone")
    ev = tf.model.eval_obj_con

    def poisoned(params, x):
        f, c, cw = ev(params, x)
        return f * float("nan"), c, cw

    tf.model = dataclasses.replace(tf.model, eval_obj_con=poisoned)
    out = tf.step(ts, td, (), None)
    assert bool(out.converged)           # stopped
    assert int(out.k) == int(ts.k)
    assert torch.equal(out.vars.x, ts.vars.x)
    assert torch.equal(out.qn.buf, ts.qn.buf)


def test_solve_counts_host_syncs():
    """FusedIP.solve: a host loop reading `converged` after each step; the
    line search reads its `done` flag once per trial."""
    _, _, _, tf, td, _ = _solvers("monotone")
    tp = TTopology(n=512, block=8, dtype=torch.float64, device="cpu")
    td, x0 = tip.data_template_from_problem(tp, dtype=torch.float64)
    tf = tip.FusedIP(tip.model_from_problem(tp), 512, 1, tp.nwcon, 1,
                     tip.FusedIPOptions(use_quasi_newton_update=True,
                                        abs_res_tol=1e-5),
                     dtype=torch.float64)
    st = tf.solve(x0, td, (), tqn.qn_init(4, 512, dtype=torch.float64,
                                          device="cpu"))
    assert bool(st.converged) and float(st.res_norm) < 1e-5
    steps = int(st.k) + 1                    # the last step froze
    # neval = 1 + Σ (trials + 1) over the steps before the frozen one
    trials = int(st.neval) - 1 - int(st.k)
    last_trials = tf.syncs.count - steps - trials
    assert 1 <= last_trials <= tf.opts.max_line_iters


def test_unported_paths_raise_and_tf32_is_off():
    tp = TTopology(n=64, block=8, dtype=torch.float64, device="cpu")
    model = tip.model_from_problem(tp)
    # the Newton-Krylov phase is ported: its options build a solver
    nk = tip.FusedIP(model, 64, 1, 8, 1,
                     tip.FusedIPOptions(use_hvec_product=True))
    assert nk.opts.gmres_subspace_size == 25
    tf = tip.FusedIP(model, 64, 1, 8, 1, tip.FusedIPOptions())
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    td, x0 = tip.data_template_from_problem(tp, dtype=torch.float64)
    # the batched solve is ported: one step of two instances
    st = tf.solve_batched(torch.stack([x0, 0.5 * x0]), td, max_iters=1)
    assert st.vars.x.shape == (2, 64) and st.k.tolist() == [1, 1]
    with pytest.raises(NotImplementedError):
        tf.solve(x0, td, (), chunk=4)


def test_import_loads_no_jax():
    """paropt_torch runs where jax is not installed: importing it (and its
    solver, facade, model, option and kernel modules) loads no jax module."""
    code = ("import sys, paropt_torch, paropt_torch.ip_fused, "
            "paropt_torch.convert, paropt_torch.ops.kernels, "
            "paropt_torch.models.topology, paropt_torch.mma, "
            "paropt_torch.optimizer, paropt_torch.tr, "
            "paropt_torch.models.fem_topology, paropt_torch.models.analytic, "
            "paropt_torch.models.fem_topology3d, "
            "paropt_torch.models.fem_frequency, paropt_torch.eig, "
            "paropt_torch.eig_fused, paropt_torch.ops.lobpcg, "
            "paropt_torch.utils.options, paropt_torch.ip, "
            "paropt_torch.problem, paropt_torch.utils.logging, "
            "paropt_torch.utils.chunked; "
            "bad = sorted(m for m in sys.modules "
            "if m == 'jax' or m.startswith(('jax.', 'jaxlib', 'paropt_tpu')));"
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
