"""The host-loop interior-point method on sparse constraints, its checks and
pieces: paropt_torch.ip against paropt_tpu.ip on the same numpy inputs, in
float64.

- Solves on SyntheticTopology(256) (one dense and 32 blocked_t sparse
  constraints) with the L-BFGS compact term, from the affine and the
  least-squares start, the latter with sparse equalities and
  per-constraint penalties: the same iteration count, fobj to 1e-10
  relative, x to 1e-8, logs that parse alike.
- The numerical phases of an iteration (`_residual_and_norms` ...
  `_trial_point`, `_nk_projections`) on the same random KKT state to 1e-12.
- `check_gradients` (central differences with the Hessian-vector and sparse
  checks, and the complex step) and `check_merit_func_gradient`, standalone
  and inside the loop.
- One iteration of each package from the same mid-solve JAX state loaded
  through `convert.load_interior_point`.
- Each piece not ported yet raises NotImplementedError naming its ROADMAP
  item; the general-CSR and callback paths (item 11) raise only where
  the JAX package does.
"""

import contextlib
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paropt_tpu import ip as jip
from paropt_tpu.models import analytic as ja
from paropt_tpu.models.topology import SyntheticTopology as JTopology
from paropt_tpu.ops import kkt as jkkt
from paropt_torch import convert
from paropt_torch import ip as tip
from paropt_torch.models import analytic as ta
from paropt_torch.models.topology import SyntheticTopology as TTopology
from paropt_torch.problem import CSRSparseProblem

from ._torch_parity import (assert_close, assert_logs_alike,
                            assert_same_ip_solve, ip_side_by_side,
                            jax_ip_state, kkt_case, np_of)

torch.set_num_threads(1)

F64 = torch.float64


def _rosen():
    return ja.Rosenbrock(), ta.Rosenbrock(dtype=F64, device="cpu")


def test_iteration_phases_match():
    """Each numerical phase of an iteration on the same random KKT state,
    with the main path's sparse layout."""
    d_np, v_np = kkt_case("blocked_t", ncon=2, k=4, nwcon=16, seed=5)
    p_np = kkt_case("blocked_t", ncon=2, k=4, nwcon=16, seed=6)[1]
    jd = jkkt.ProblemData(**{k: (jnp.asarray(v) if isinstance(v, np.ndarray)
                                 else v) for k, v in d_np.items()})
    jv = jkkt.IPVars(**{k: jnp.asarray(v) for k, v in v_np.items()})
    jp = jkkt.IPVars(**{k: jnp.asarray(v) for k, v in p_np.items()})
    td = convert.problem_data(d_np, device="cpu")
    tv = convert.ip_vars(v_np, device="cpu")
    tp = convert.ip_vars(p_np, device="cpu")
    n = td.n
    rng = np.random.default_rng(7)
    Z = rng.standard_normal((4, n))
    M = np.eye(4) * 5.0 + 0.1 * rng.standard_normal((4, 4))
    jc = (jnp.asarray(1.3), jnp.asarray(Z), jnp.asarray(M))
    tc = tuple(torch.tensor(a, dtype=F64) for a in (1.3, Z, M))
    mu, rbb = 0.05, 1.0

    def both(name, jargs, targs, **kw):
        return (getattr(jip, name)(*jargs, **kw),
                getattr(tip, name)(*targs, **kw))

    def same(jout, tout, rtol=1e-12, what=""):
        jl, tl = jax_leaves(jout), jax_leaves(tout)
        assert len(jl) == len(tl)
        for j, t in zip(jl, tl):
            j, t = np_of(j), np_of(t)
            if j.dtype == bool:
                np.testing.assert_array_equal(t, j, err_msg=what)
                continue
            scale = float(np.max(np.abs(j), initial=0.0))
            assert_close(t, j, rtol=rtol, atol=rtol * max(scale, 1e-300),
                         name=what)

    same(*both("_residual_and_norms", (jv, jd, mu, rbb), (tv, td, mu, rbb),
               norm_type="l2"), what="norms")
    same(*both("_compute_step", (jv, jd, jc, mu, rbb, 0.0),
               (tv, td, tc, mu, rbb, 0.0), refine_steps=1, use_qn=True),
         rtol=1e-10, what="step")
    same(*both("_check_kkt_step", (jv, jd, jp, jc, mu, rbb, 0.0),
               (tv, td, tp, tc, mu, rbb, 0.0), use_qn=True), what="K p + r")
    comp = 0.2
    js = jip._scale_step(jv, jd, jp, jnp.asarray(mu), jnp.asarray(comp),
                         jnp.asarray(False), 0.95)
    ts = tip._scale_step(tv, td, tp, torch.tensor(mu, dtype=F64),
                         torch.tensor(comp, dtype=F64), 0.95)
    same(js, ts, what="scale")
    fobj = 0.7
    same(*both("_merit_parts", (jv, jd, jp, jnp.asarray(fobj), mu, rbb, jc),
               (tv, td, tp, torch.tensor(fobj, dtype=F64), mu, rbb, tc),
               use_qn=True), rtol=1e-11, what="merit parts")
    same(*both("_nk_projections", (jv, jd, jp, jv, mu, rbb),
               (tv, td, tp, tv, mu, rbb)), rtol=1e-11, what="nk")
    same(*both("_apply_step", (jv, jd, jp, 0.3, 1e-14),
               (tv, td, tp, 0.3, 1e-14)), what="apply")
    jt = jip._trial_point(jv, jd, jp, 0.3, 1e-14)
    tt = tip._trial_point(tv, td, tp, 0.3, 1e-14)
    same(jt, tt, what="trial")
    same(*both("_merit_eval", (*jt, jnp.asarray(fobj), jd.c, jd.cw, jd, mu,
                               rbb, 2.0),
               (*tt, torch.tensor(fobj, dtype=F64), td.c, td.cw, td, mu, rbb,
                2.0)), what="merit")


def jax_leaves(obj):
    """The tensors of a (nested) tuple of states, in field order."""
    if dataclasses.is_dataclass(obj):
        return [getattr(obj, f.name) for f in dataclasses.fields(obj)]
    if isinstance(obj, (tuple, list)):
        return [leaf for o in obj for leaf in jax_leaves(o)]
    return [obj]


@pytest.mark.parametrize("start", ["affine_step", "least_squares_multipliers"])
def test_sparse_constraints_match(start, tmp_path):
    """The sparse path of the host loop: the blocked_t Jacobian in the
    problem data, the affine start with nwcon > 0, and the least-squares
    start's Cw Cholesky branch.  In the least-squares case the last 16
    sparse constraints are equalities (``nwinequality`` 16) and
    `set_penalty_gamma` sets per-constraint dense and sparse penalties, so
    gamma_sw is zero on the inequalities only.  15 iterations; the problem
    does not converge at this size in 80."""
    equalities = start == "least_squares_multipliers"
    jprob = JTopology(n=256, block=8)
    tprob = TTopology(n=256, block=8, dtype=F64, device="cpu")
    if equalities:
        jprob.nwinequality = tprob.nwinequality = 16

    def setup(solver, package):
        if equalities:
            solver.set_penalty_gamma(np.array([7.0]),
                                     np.linspace(5.0, 20.0, 32))

    opts = {"starting_point_strategy": start, "qn_subspace_size": 10,
            "abs_res_tol": 1e-6, "max_major_iters": 15}
    jr, tr, js, ts = ip_side_by_side(jprob, tprob, opts, tmp_path, setup)
    assert_same_ip_solve(jr, tr, tmp_path)
    assert tr["niter"] == 14
    for name in ("gamma_s", "gamma_t", "gamma_sw", "gamma_tw"):
        assert_close(getattr(ts, name), getattr(js, name), rtol=0.0,
                     name=name)
    assert int(torch.count_nonzero(ts.gamma_sw)) == (16 if equalities else 0)
    assert ts.qn is not None and ts.qn.buf.shape == (20, 256)


def test_check_gradients_matches():
    """Central differences with the Hessian-vector and sparse checks, and
    the complex step: the same checks in both packages, each small, and
    each package's error beside the other's.  The complex-step errors and
    the exact checks (repeatability, adjoint, inner product) agree to
    roundoff; a central-difference error, itself roundoff of the
    difference quotient, within a factor of 2."""
    exact = {"hvec_repeat", "sparse_adjoint", "sparse_inner_product"}
    for jprob, tprob, mode, keys, tol in (
            (ja.SparseRosenbrock(),
             ta.SparseRosenbrock(dtype=F64, device="cpu"), "central",
             ["obj_gradient", "hvec_repeat", "hvec_product",
              "sparse_jacobian", "sparse_adjoint", "sparse_inner_product"],
             1e-6),
            (ja.Rosenbrock(), ta.Rosenbrock(dtype=F64, device="cpu"),
             "complex", ["obj_gradient", "con_gradient"], 1e-12)):
        jout = jprob.check_gradients(check_hvec_product=True, verbose=False,
                                     mode=mode)
        tout = tprob.check_gradients(check_hvec_product=True, verbose=False,
                                     mode=mode)
        assert list(tout) == list(jout) == keys
        for key, val in tout.items():
            assert val < tol and jout[key] < tol, (key, val, jout[key])
            if mode == "complex" or key in exact:
                assert val == pytest.approx(jout[key], rel=1e-6, abs=1e-15)
            else:
                assert val == pytest.approx(jout[key], rel=0.5, abs=1e-15)


def test_check_merit_func_gradient_matches(tmp_path):
    """The merit derivative check at a given point with the reference's probe
    direction, and along the actual steps inside the loop
    (``gradient_verification_frequency``)."""
    jprob, tprob = _rosen()
    opts = {"output_file": None}
    jfd, jdm, _, _ = jip.InteriorPoint(jprob, opts).check_merit_func_gradient(
        xpt=np.array([0.2, -0.3]), dh=1e-7)
    tfd, tdm, _, trel = tip.InteriorPoint(
        tprob, opts).check_merit_func_gradient(xpt=np.array([0.2, -0.3]),
                                               dh=1e-7)
    assert tdm == pytest.approx(jdm, rel=1e-12)
    assert tfd == pytest.approx(jfd, rel=1e-6)
    assert trel < 1e-5
    opts = {"gradient_verification_frequency": 2,
            "gradient_check_step_length": 1e-7, "max_major_iters": 6}
    jr = jip.InteriorPoint(jprob, dict(opts, output_file=str(
        tmp_path / "j"))).optimize()
    tr = tip.InteriorPoint(tprob, dict(opts, output_file=str(
        tmp_path / "t"))).optimize()
    assert tr["niter"] == jr["niter"]
    assert_close(tr["x"], jr["x"], rtol=0.0, atol=1e-8, name="x")
    assert_logs_alike(tmp_path / "j", tmp_path / "t", "ip")
    text = (tmp_path / "t").read_text()
    assert text.count("Merit function test") == \
        (tmp_path / "j").read_text().count("Merit function test") == 3


def test_one_iteration_from_jax_state():
    """Six iterations of the JAX solve, then one more iteration of each
    package from that state (`convert.load_interior_point`): every IPVars
    field, the QN state, μ and ρ to 1e-12."""
    opts = {"output_file": None, "max_major_iters": 6}
    js = jip.InteriorPoint(ja.Rosenbrock(), opts)
    js.optimize()
    state = jax_ip_state(js)
    one = dict(opts, max_major_iters=1,
               starting_point_strategy="no_start_strategy")
    jn = jip.InteriorPoint(ja.Rosenbrock(), one)
    jn.vars = dataclasses.replace(js.vars)
    jn.qn, jn.mu, jn.rho_penalty = js.qn, js.mu, js.rho_penalty
    tn = convert.load_interior_point(
        tip.InteriorPoint(ta.Rosenbrock(dtype=F64, device="cpu"), one), state)
    assert tn.mu == js.mu and tn.niter == js.niter
    jn.optimize()
    tn.optimize()
    for f in dataclasses.fields(jn.vars):
        assert_close(getattr(tn.vars, f.name), getattr(jn.vars, f.name),
                     rtol=1e-12, atol=1e-14, name=f.name)
    for name in ("buf", "SS", "SY", "b0"):
        assert_close(getattr(tn.qn, name), getattr(jn.qn, name), rtol=1e-12,
                     atol=1e-14, name=name)
    assert (tn.mu, tn.rho_penalty) == pytest.approx((jn.mu, jn.rho_penalty),
                                                    rel=1e-12)


def _small():
    return TTopology(n=64, block=8, dtype=F64, device="cpu")


def test_gmres_phase_raises():
    """The Newton-Krylov phase is ported (ROADMAP item 7): the options that
    raised now solve, with GMRES steps (tests/test_torch_gmres.py holds the
    phase against paropt_tpu)."""
    ip = tip.InteriorPoint(_small(), {"output_file": None,
                                      "use_hvec_product": True,
                                      "gmres_subspace_size": 10,
                                      "nk_switch_tol": 1.0})
    res = ip.optimize()
    assert res["converged"] and ip.nhvec > 0


@contextlib.contextmanager
def _gloo(tmp_path):
    """A one-rank gloo group and its ("d",) mesh, for sharded state."""
    import torch.distributed as dist
    from paropt_torch.parallel.sharding import design_mesh
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'pg'}",
                            rank=0, world_size=1)
    try:
        yield design_mesh("cpu")
    finally:
        dist.destroy_process_group()


def test_checkpoints_raise(tmp_path):
    """Checkpoints are ported (ROADMAP item 13; tests/
    test_torch_checkpoint.py holds them against paropt_tpu): the calls
    that raised write and read the npz solution file, and
    ``optimize(checkpoint=...)`` rewrites it at the write-output cadence.
    A directory, which raised until item 14a, is the checkpoint of sharded
    state: written and read back whole (tests/test_torch_sharding.py holds
    its placements)."""
    path = str(tmp_path / "x.npz")
    ip = tip.InteriorPoint(_small(), {"output_file": None,
                                      "write_output_frequency": 3})
    res = ip.optimize(checkpoint=path)
    assert res["converged"]
    with np.load(path) as dat:
        assert dat["x"].shape == (64,) and float(dat["mu"]) > 0.0
    ip.write_solution_file(path)
    again = tip.InteriorPoint(_small(), {"output_file": None})
    again.read_solution_file(path)
    assert torch.equal(again.vars.x, ip.vars.x) and again.mu == ip.mu
    from paropt_torch.parallel.sharding import shard_tree
    with _gloo(tmp_path) as mesh:
        ip.vars = shard_tree(ip.vars, mesh, 64)
        ip.write_solution_file(str(tmp_path / "sharded"))
        fresh = tip.InteriorPoint(_small(), {"output_file": None})
        fresh.read_solution_file(str(tmp_path / "sharded"))
        assert torch.equal(fresh.vars.x, again.vars.x)
        assert fresh.mu == again.mu


def test_general_csr_path_raises():
    """The general-CSR path is ported (tests/test_torch_csr.py holds it
    against paropt_tpu): a CSR problem that does not fill its Jacobian
    values raises NotImplementedError naming the method to override, and a
    pattern without values does not factor."""
    prob = CSRSparseProblem(4, 0, [0, 2], [0, 1], device="cpu")
    assert prob.use_csr_path and prob.nwcon == 1
    with pytest.raises(NotImplementedError,
                       match="eval_sparse_jacobian_data"):
        prob.sparse_jacobian(torch.zeros(4, dtype=F64))
    mat = prob.create_quasi_def_mat()
    assert mat.get_factor_info() == "unfactored"
    with pytest.raises(RuntimeError, match="not positive definite"):
        mat.factor(np.ones(4), np.zeros(1))


def test_callback_sparse_path_raises():
    """Sparse constraints without a structured Jacobian take the
    callback-product path; a sparse_jacobian that raises anything else
    propagates."""
    prob = _small()
    prob.sparse_jacobian = lambda x: (_ for _ in ()).throw(
        NotImplementedError("no structured Jacobian"))
    ip = tip.InteriorPoint(prob, {"output_file": None})
    assert ip._callback_sparse and ip._eager and ip._csr_mat is None
    prob.sparse_jacobian = lambda x: (_ for _ in ()).throw(
        ValueError("bug in user Jacobian"))
    with pytest.raises(ValueError, match="bug in user Jacobian"):
        tip.InteriorPoint(prob, {"output_file": None})


def test_sharded_state_raises(tmp_path):
    """A design vector distributed over a device mesh (a DTensor), which
    raised until ROADMAP item 14a, now solves: the same iterations,
    objective and point as the plain vector, x still sharded
    (tests/test_torch_distributed.py holds it on 4 ranks)."""
    from torch.distributed.tensor import Shard, distribute_tensor
    plain = tip.InteriorPoint(_small(), {"output_file": None}).optimize()
    with _gloo(tmp_path) as mesh:
        prob = _small()
        x0, lb, ub = prob.get_vars_and_bounds()
        prob.get_vars_and_bounds = lambda: (
            distribute_tensor(x0, mesh, [Shard(0)]), lb, ub)
        res = tip.InteriorPoint(prob, {"output_file": None}).optimize()
        assert res["x"].placements == (Shard(0),)
        assert res["niter"] == plain["niter"] and res["converged"]
        assert res["fobj"] == pytest.approx(plain["fobj"], rel=1e-13)
        torch.testing.assert_close(res["x"].full_tensor(), plain["x"],
                                   rtol=0, atol=1e-12)
