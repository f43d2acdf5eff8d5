"""The fused SL1QP trust region (counterpart of paropt_tpu/tr.py:54-122 and
:1016-1417, where the method is documented), and the registry ->
`FusedIPOptions` mapping shared with the facade's fused IP solve.

Each outer iteration builds the trust-region box about xk, runs the
steering infeasibility solve and the QP solve with the fused interior-point
solver on a quadratic model of the problem (compact quasi-Newton objective,
linearized constraints), evaluates the trial point once, updates the
quasi-Newton state, accepts or rejects the step, resizes the radius, adapts
the per-constraint penalties and tests the normalized KKT error.  The JAX
package runs the whole loop as one ``lax.while_loop``; here it is a host
loop that reads ``converged`` once per outer iteration, and the inner
solves read the device once per line-search trial and once per step.
``FusedTR.syncs`` counts every such read.

Not ported yet: ``FusedTR.solve_batched``, the host-loop `TrustRegion`
(filter, second-order correction) and the eigenvalue row of the QP model.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch
from torch.profiler import record_function

from .ip_fused import (FusedIPOptions, HostSyncs, ModelFns, _fused_init,
                       _fused_solve_loop)
from .ops import qn as qnmod
from .ops.kkt import ProblemData
from .utils.options import make_options

__all__ = ["QPParams", "make_qp_model", "FusedTR", "FusedTROptions",
           "FusedTRState", "_fused_ip_options"]


def _fused_ip_options(o, barrier: str, start: str,
                      slm: bool) -> FusedIPOptions:
    """Map the registry's IP options onto the inner fused-IP solver's
    options (forced overrides per `sl1qpOptimize`,
    `ParOptTrustRegion.cpp:1490-1500`: use_quasi_newton_update off, the
    outer loop owns the QN update).  'default' resolves to affine_step and
    to the main barrier strategy."""
    if start == "default":
        start = "affine_step"
    if barrier == "default":
        barrier = o["barrier_strategy"]
    return FusedIPOptions(
        abs_res_tol=o["abs_res_tol"],
        init_barrier_param=o["init_barrier_param"],
        monotone_barrier_fraction=o["monotone_barrier_fraction"],
        monotone_barrier_power=o["monotone_barrier_power"],
        rel_bound_barrier=o["rel_bound_barrier"],
        min_fraction_to_boundary=o["min_fraction_to_boundary"],
        penalty_descent_fraction=o["penalty_descent_fraction"],
        min_rho_penalty_search=o["min_rho_penalty_search"],
        armijo_constant=o["armijo_constant"],
        function_precision=o["function_precision"],
        design_precision=o["design_precision"],
        max_line_iters=o["max_line_iters"],
        use_backtracking_alpha=o["use_backtracking_alpha"],
        max_major_iters=o["max_major_iters"],
        iterative_refinement_steps=o["iterative_refinement_steps"],
        qn_sigma=o["qn_sigma"],
        barrier_strategy=barrier,
        starting_point_strategy=start,
        start_affine_multiplier_min=o["start_affine_multiplier_min"],
        use_line_search=o["use_line_search"],
        use_quasi_newton_update=False,
        sequential_linear_method=slm,
        norm_type=o["norm_type"])


# ---------------------------------------------------------------------------
# the quadratic subproblem model the inner solves run on
# ---------------------------------------------------------------------------


class QPParams(NamedTuple):
    """Linearization data of the quadratic subproblem model."""
    fk: Any
    gk: Any
    ck: Any
    Ak: Any
    cwk: Any            # [nwcon] (empty when unused)
    Aw_cols: Any        # sparse Jacobian at xk ([nwcon, k] or None)
    Aw_vals: Any
    b0: Any             # compact-QN pieces (B = b0 I - Z' M^{-1} Z)
    Z: Any              # may be None
    M: Any
    obj_scale: Any      # 1 for the QP; 1/gamma_big for the steering solve
    # the eigenvalue row's curvature (paropt_tpu/tr.py:73-77) is not
    # ported yet: make_qp_model raises when these are set
    eig_M: Any = None
    eig_h: Any = None


def _qp_Bp(params: QPParams, p):
    """B p for the compact form in ``params``: `qn_mult`'s formula, which
    the outer step's model reduction also uses."""
    if params.Z is None:
        return params.b0 * p
    return qnmod.qn_mult(None, p, compact=(params.b0, params.Z, params.M))


def make_qp_model(has_sparse: bool, obj_mode: str) -> ModelFns:
    """Model functions of the (possibly sparse-constrained) QP subproblem;
    ``obj_mode`` is 'quadratic' or 'linear'."""

    def ev(params: QPParams, p):
        if params.eig_M is not None or params.eig_h is not None:
            raise NotImplementedError(
                "the eigenvalue row of the QP model is not ported yet "
                "(ROADMAP queue 1 item 12)")
        f = params.fk + torch.dot(params.gk, p)
        if obj_mode == "quadratic":
            f = f + 0.5 * torch.dot(p, _qp_Bp(params, p))
        f = params.obj_scale * f
        c = (params.ck + params.Ak @ p) if params.ck.shape[0] else params.ck
        if has_sparse:
            gathered = p[..., params.Aw_cols]
            cw = params.cwk + torch.sum(params.Aw_vals * gathered, dim=-1)
        else:
            cw = params.cwk
        return f, c, cw

    def gr(params: QPParams, p):
        g = params.gk
        if obj_mode == "quadratic":
            g = g + _qp_Bp(params, p)
        return params.obj_scale * g, params.Ak

    return ModelFns(eval_obj_con=ev, eval_grad=gr, hess_diag=None)


# ---------------------------------------------------------------------------
# the fused outer loop
# ---------------------------------------------------------------------------


class FusedTROptions(NamedTuple):
    """Outer-loop options (mirror the tr_* registry entries)."""
    max_iterations: int = 200
    infeas_tol: float = 1e-5
    l1_tol: float = 1e-6
    linf_tol: float = 1e-6
    eta: float = 0.25
    tr_min: float = 1e-3
    tr_max: float = 1.0
    init_size: float = 0.1
    bound_relax: float = 1e-4
    function_precision: float = 1e-10
    adaptive_gamma: bool = True
    gamma_max: float = 1e4
    gamma_min: float = 0.0
    penalty_gamma: float = 1000.0       # elastic gamma for sparse cons
    ninequality: int = 0
    nwinequality: int = 0


@dataclasses.dataclass(frozen=True)
class FusedTRState:
    """Outer-loop state: the linearization point and the TR machinery."""
    xk: torch.Tensor
    fk: torch.Tensor
    ck: torch.Tensor
    gk: torch.Tensor
    Ak: torch.Tensor
    cwk: torch.Tensor
    qn: Optional[qnmod.QNState]
    tr_size: torch.Tensor
    gamma: torch.Tensor        # [ncon] per-constraint penalties
    k: torch.Tensor            # outer iteration counter (int32)
    subiters: torch.Tensor     # cumulative inner IP iterations (int32)
    converged: torch.Tensor    # bool
    infeas: torch.Tensor
    l1: torch.Tensor
    linf: torch.Tensor
    rho: torch.Tensor          # last actual/model reduction ratio


def _viol(c, nineq):
    """Per-constraint violation: max(0, -c) for inequalities, |c| for
    equalities (`ParOptTrustRegion.cpp:1620-1665`)."""
    if c.shape[0] == 0:
        return c
    idx = torch.arange(c.shape[0], device=c.device)
    return torch.where(idx < nineq, torch.clamp(-c, min=0.0), torch.abs(c))


def _fused_tr_step(user_model: ModelFns, qp_model: ModelFns,
                   inf_model: ModelFns, qp_opts: FusedIPOptions,
                   inf_opts: FusedIPOptions, to: FusedTROptions,
                   lbv, ubv, d_tmpl: ProblemData, params_user,
                   state: FusedTRState, host=bool) -> FusedTRState:
    """One SL1QP outer iteration (`sl1qpOptimize` loop body +
    `sl1qpUpdate`, `ParOptTrustRegion.cpp:1544-1671, 1231-1452`).
    ``host`` reads a device flag on the host (the inner solves' reads)."""
    xk, fk, ck, gk, Ak, cwk = (state.xk, state.fk, state.ck, state.gk,
                               state.Ak, state.cwk)
    dt = xk.dtype
    dev = xk.device
    kw = dict(dtype=dt, device=dev)
    ncon = ck.shape[0]
    nwcon = d_tmpl.nwcon
    nineq = to.ninequality
    idx = torch.arange(ncon, device=dev)
    zero = torch.zeros((), **kw)

    # -- trust-region bounds (`initModelAndBounds`/`setTrustRegionBounds`) --
    lk = torch.maximum(-state.tr_size, lbv - xk)
    uk = torch.minimum(state.tr_size, ubv - xk)
    p0 = 0.5 * (lk + uk)

    # compact quasi-Newton pieces of the QP objective
    if state.qn is not None:
        b0, Z, M = qnmod.qn_compact(state.qn)
    else:
        b0, Z, M = zero + 1.0, None, None
    params = QPParams(fk=fk, gk=gk, ck=ck, Ak=Ak, cwk=cwk,
                      Aw_cols=d_tmpl.Aw_cols, Aw_vals=d_tmpl.Aw_vals,
                      b0=b0, Z=Z, M=M, obj_scale=zero + 1.0)

    # -- steering infeasibility solve (`minimizeInfeas`) --------------------
    if to.adaptive_gamma:
        gamma_big = max(1e6, 1e2 * to.gamma_max)
        inf_params = params._replace(obj_scale=zero + 1.0 / gamma_big)
        ones = torch.ones(ncon, **kw)
        ones_w = torch.ones(nwcon, **kw)
        d_inf = dataclasses.replace(
            d_tmpl, lb=lk, ub=uk,
            gamma_s=torch.where(idx < nineq, 0.0, ones), gamma_t=ones,
            gamma_sw=torch.where(torch.arange(nwcon, device=dev)
                                 < to.nwinequality, 0.0, ones_w),
            gamma_tw=ones_w)
        with record_function("paropt.tr.steer"):
            st_inf0 = _fused_init(inf_model, inf_opts, p0, d_inf, inf_params,
                                  None, None)
            st_inf = _fused_solve_loop(inf_model, inf_opts, st_inf0, d_inf,
                                       inf_params, None, host)
        c_best = (ck + Ak @ st_inf.vars.x) if ncon else ck
        best_con_infeas = _viol(c_best, nineq)
        inf_iters = st_inf.k
    else:
        best_con_infeas = torch.zeros(ncon, **kw)
        inf_iters = torch.zeros((), dtype=torch.int32, device=dev)

    # -- QP subproblem solve (IP-on-QP, the hot loop) ------------------------
    d_qp = dataclasses.replace(
        d_tmpl, lb=lk, ub=uk,
        gamma_s=torch.where(idx < nineq, 0.0, state.gamma),
        gamma_t=state.gamma)
    compact = (b0, Z, M)
    with record_function("paropt.tr.qp"):
        st0 = _fused_init(qp_model, qp_opts, p0, d_qp, params, None, compact)
        st = _fused_solve_loop(qp_model, qp_opts, st0, d_qp, params, compact,
                               host)
    p, z, zw = st.vars.x, st.vars.z, st.vars.zw

    # -- model reductions (`sl1qpUpdate`) ------------------------------------
    gam = state.gamma
    infeas_k = torch.sum(gam * _viol(ck, nineq)) if ncon else zero
    cm = (ck + Ak @ p) if ncon else ck
    fm = fk + torch.dot(gk, p)
    if state.qn is not None:
        fm = fm + 0.5 * torch.dot(p, _qp_Bp(params, p))
    obj_reduc = fk - fm
    infeas_model = torch.sum(gam * _viol(cm, nineq)) if ncon else zero

    # -- trial evaluation + quasi-Newton update (`evalTrialStepAndUpdate`,
    #    update_flag=True: the QN updates on the trial REGARDLESS of
    #    acceptance, `ParOptTrustRegion.cpp:172-212`) ------------------------
    xt = xk + p
    with record_function("paropt.tr.eval"):
        ft, ct, cwt = user_model.eval_obj_con(params_user, xt)
        gt, At = user_model.eval_grad(params_user, xt)
    # fail-stop on non-finite trial data: a NaN/Inf trial is never
    # accepted, never reaches the QN state, and shrinks the radius
    trial_finite = (torch.isfinite(ft) & torch.all(torch.isfinite(ct))
                    & torch.all(torch.isfinite(gt))
                    & torch.all(torch.isfinite(p)))
    qn_new = state.qn
    if state.qn is not None:
        with record_function("paropt.tr.qn_update"):
            # y = grad_x L(xt, z) - grad_x L(xk, z); the CONSTANT sparse
            # Jacobian's Aw^T zw term is identical at both points and
            # cancels, so it is not formed
            if ncon:
                y = (gt - At.T @ z) - (gk - Ak.T @ z)
            else:
                y = gt - gk
            qn_new, _, _ = qnmod.qn_update(state.qn, p, y,
                                           accept=trial_finite)

    infeas_t = torch.sum(gam * _viol(ct, nineq)) if ncon else zero
    actual_reduc = (fk - ft) + (infeas_k - infeas_t)
    model_reduc = obj_reduc + (infeas_k - infeas_model)
    fprec = to.function_precision
    both_tiny = ((torch.abs(model_reduc) <= fprec)
                 & (torch.abs(actual_reduc) <= fprec))
    rho = torch.where(both_tiny | (model_reduc == 0.0), 1.0,
                      actual_reduc / torch.where(model_reduc == 0.0, 1.0,
                                                 model_reduc))
    # a non-finite trial counts as maximal disagreement: reject + shrink
    rho = torch.where(trial_finite, rho, -float("inf"))

    # -- accept / reject + radius update (`:1353-1372`) ----------------------
    accepted = ((rho >= to.eta)
                | ((state.tr_size <= to.tr_min) & trial_finite))

    def sel(a, b):
        return torch.where(accepted, a, b)

    xk_n, fk_n, ck_n = sel(xt, xk), sel(ft, fk), sel(ct, ck)
    gk_n, Ak_n = sel(gt, gk), sel(At, Ak)
    # cw at the accepted point comes from the trial evaluation
    cwk_n = sel(cwt, cwk) if nwcon > 0 else cwk
    tr = state.tr_size
    tr_n = torch.where(rho < 0.25, torch.clamp(0.25 * tr, min=to.tr_min),
                       torch.where(rho > 0.75,
                                   torch.clamp(1.5 * tr, max=to.tr_max), tr))

    # -- adaptive per-constraint penalties (`:1609-1671`) --------------------
    gamma_n = state.gamma
    if to.adaptive_gamma and ncon:
        zabs = torch.abs(z)
        con_infeas = _viol(ck, nineq)
        model_con_infeas = _viol(cm, nineq)
        infeas_reduction = con_infeas - model_con_infeas
        best_reduction = con_infeas - best_con_infeas
        shrink = ((zabs > to.infeas_tol) & (con_infeas < to.infeas_tol)
                  & (gamma_n >= 2.0 * zabs))
        grow = ((con_infeas > to.infeas_tol)
                & (0.995 * best_reduction > infeas_reduction))
        gamma_n = torch.where(
            shrink, torch.clamp(0.5 * (gamma_n + zabs), min=to.gamma_min),
            torch.where(grow, torch.clamp(1.5 * gamma_n, max=to.gamma_max),
                        gamma_n))

    # -- KKT error at the post-update point (`computeKKTError`,
    #    `ParOptTrustRegion.cpp:2391-2470`) ----------------------------------
    r = gk_n - Ak_n.T @ z if ncon else gk_n
    if nwcon > 0:
        r = r - d_tmpl.Aw_rmatvec(zw)
    relax = to.bound_relax
    r = torch.where((xk_n <= lbv + relax) & (r > 0.0), 0.0, r)
    r = torch.where((xk_n >= ubv - relax) & (r < 0.0), 0.0, r)
    l1_raw = torch.sum(torch.abs(r))
    linf_raw = torch.max(torch.abs(r)) if r.numel() else zero
    zmax = zero + 1.0
    if ncon:
        zmax = torch.maximum(zmax, torch.max(torch.abs(z)))
    if nwcon:
        zmax = torch.maximum(zmax, torch.max(torch.abs(zw)))
    l1 = l1_raw / torch.maximum(torch.sum(torch.abs(gk_n)), zmax)
    linf = linf_raw / torch.maximum(torch.max(torch.abs(gk_n)), zmax)
    infeas_new = torch.sum(_viol(ct, nineq)) if ncon else zero
    converged = ((infeas_new < to.infeas_tol)
                 & ((l1 < to.l1_tol) | (linf < to.linf_tol)))

    return FusedTRState(
        xk=xk_n, fk=fk_n, ck=ck_n, gk=gk_n, Ak=Ak_n, cwk=cwk_n, qn=qn_new,
        tr_size=tr_n, gamma=gamma_n, k=state.k + 1,
        subiters=state.subiters + st.k + inf_iters, converged=converged,
        infeas=infeas_new, l1=l1, linf=linf, rho=rho)


class FusedTR:
    """Fused SL1QP trust-region solver (the reference's default algorithm)
    for a problem written in torch, on the problem's device.  The problem's
    sparse Jacobian (if any) must be CONSTANT in x: its values are captured
    once at x0.  Options use the standard tr_*/IP registry names; ``dtype``
    selects the solver's precision.  Constructing a solver turns TF32 off
    for float32 matrix products and convolutions, as `FusedIP` does: the
    inner solves are built from the step functions, not from a `FusedIP`."""

    def __init__(self, problem, options: Optional[Dict[str, Any]] = None):
        o = options if hasattr(options, "descriptors") else \
            make_options(options or {}, which="facade")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dt = torch.float64 if o["dtype"] == "float64" else torch.float32
        x0, lb, ub = problem.get_vars_and_bounds()
        dev = x0.device
        kw = dict(dtype=dt, device=dev)
        x0, lbv, ubv = x0.to(dt), lb.to(dt), ub.to(dt)
        n, ncon, nwcon = problem.nvars, problem.ncon, problem.nwcon

        def ev(params, x):
            f, c = problem.eval_obj_con(x)
            cwv = (problem.eval_sparse_con(x).to(dt) if nwcon > 0
                   else x.new_zeros(0))
            return f.to(dt), c.to(dt).reshape(ncon), cwv

        def gr(params, x):
            g, A = problem.eval_obj_con_gradient(x)
            return g.to(dt), A.to(dt).reshape(ncon, n)

        user_model = ModelFns(eval_obj_con=ev, eval_grad=gr)
        has_sp = nwcon > 0
        qp_model = make_qp_model(has_sp, "quadratic")
        obj_mode = {"linear_objective": "linear",
                    "constant_objective": "linear",
                    "subproblem_objective": "quadratic"}[
                        o["tr_adaptive_objective"]]
        inf_model = make_qp_model(has_sp, obj_mode)

        if nwcon > 0:
            Aw = problem.sparse_jacobian(x0)
            cols, vals, layout = Aw.cols, Aw.vals.to(dt), Aw.layout
        else:
            cols = vals = None
            layout = "gather"
        gamma = o["penalty_gamma"]
        ones = torch.ones(n, **kw)
        d_tmpl = ProblemData(
            g=torch.zeros(n, **kw), A=torch.zeros((ncon, n), **kw),
            c=torch.zeros(ncon, **kw), cw=torch.zeros(nwcon, **kw),
            lb=lbv, ub=ubv, lb_mask=ones, ub_mask=ones,
            gamma_s=torch.zeros(ncon, **kw), gamma_t=torch.zeros(ncon, **kw),
            gamma_sw=torch.as_tensor(
                np.where(np.arange(nwcon) < problem.nwinequality, 0.0,
                         gamma), **kw),
            gamma_tw=torch.full((nwcon,), gamma, **kw),
            Aw_cols=cols, Aw_vals=vals, nwblock=problem.nwblock,
            Aw_layout=layout)

        slm = (o["tr_adaptive_objective"] in ("linear_objective",
                                              "constant_objective")
               and o["tr_adaptive_constraint"] == "linear_constraint")
        qp_opts = _fused_ip_options(o, o["barrier_strategy"],
                                    o["starting_point_strategy"], False)
        inf_opts = _fused_ip_options(
            o, o["tr_steering_barrier_strategy"],
            o["tr_steering_starting_point_strategy"], slm)
        to = FusedTROptions(
            max_iterations=o["tr_max_iterations"],
            infeas_tol=o["tr_infeas_tol"], l1_tol=o["tr_l1_tol"],
            linf_tol=o["tr_linfty_tol"], eta=o["tr_eta"],
            tr_min=o["tr_min_size"], tr_max=o["tr_max_size"],
            init_size=o["tr_init_size"], bound_relax=o["tr_bound_relax"],
            function_precision=o["function_precision"],
            adaptive_gamma=o["tr_adaptive_gamma_update"],
            gamma_max=o["tr_penalty_gamma_max"],
            gamma_min=o["tr_penalty_gamma_min"],
            penalty_gamma=gamma,
            ninequality=problem.ninequality,
            nwinequality=problem.nwinequality)

        qn0 = None
        msub = qnmod.resolve_subspace_size(
            o["qn_subspace_size"], o["qn_subspace_auto"], n, dt)
        if o["qn_type"] != "none" and msub > 0:
            from .ip import _resolve_qn_storage
            qn0 = qnmod.qn_init(
                msub, n, dtype=dt, qn_type=o["qn_type"],
                storage_dtype=_resolve_qn_storage(o["qn_storage_dtype"], dt),
                update_type=o["qn_update_type"],
                diag_type=o["qn_diag_type"], device=dev)

        # initial linearization at x0
        f0, c0, cw0 = ev((), x0)
        g0, A0 = gr((), x0)
        zero = torch.zeros((), **kw)
        zero_i = torch.zeros((), dtype=torch.int32, device=dev)
        self._state0 = FusedTRState(
            xk=x0, fk=f0, ck=c0, gk=g0, Ak=A0, cwk=cw0, qn=qn0,
            tr_size=zero + to.init_size,
            gamma=torch.full((ncon,), gamma, **kw),
            k=zero_i, subiters=zero_i,
            converged=torch.zeros((), dtype=torch.bool, device=dev),
            infeas=zero + float("inf"), l1=zero + float("inf"),
            linf=zero + float("inf"), rho=zero)
        self.syncs = HostSyncs()
        self._to = to
        self._problem = problem
        self._write_freq = o["tr_write_output_frequency"]
        self._step = functools.partial(
            _fused_tr_step, user_model, qp_model, inf_model, qp_opts,
            inf_opts, to, lbv, ubv, d_tmpl, (), host=self.syncs)

    def solve(self, state0: Optional[FusedTRState] = None,
              checkpoint_path=None):
        """Run the outer loop: a host loop over outer iterations that reads
        ``converged`` after each.  Returns (result dict, final state).  Pass
        a previous final state to resume.  The problem's
        ``write_output(it, x)`` hook fires every
        ``tr_write_output_frequency`` outer iterations; checkpoints are not
        ported yet."""
        from .utils.chunked import make_write_output_hook, user_write_output
        hook = make_write_output_hook(user_write_output(self._problem),
                                      self._write_freq,
                                      checkpoint_path=checkpoint_path)
        state = state0 if state0 is not None else self._state0
        for _ in range(self._to.max_iterations):
            state = self._step(state)
            if hook is not None:
                hook(state)
            if self.syncs(state.converged):
                break
        result = {"x": state.xk, "fobj": float(state.fk),
                  "converged": bool(state.converged), "niter": int(state.k),
                  "infeas": float(state.infeas), "l1": float(state.l1),
                  "linfty": float(state.linf),
                  "tr_size": float(state.tr_size),
                  "subiters": int(state.subiters)}
        return result, state

    def solve_batched(self, x0_batch, chunk="auto"):
        raise NotImplementedError(
            "FusedTR.solve_batched is not ported yet (ROADMAP queue 1 "
            "item 8)")
