"""The fused eigenvalue-constrained trust region (counterpart of
paropt_tpu/eig_fused.py, where the method is documented): each outer
iteration runs the steering and QP inner solves on the merged compact
Hessian (objective QN and the z0-scaled low-rank curvature of the eigen
row), prices the trial with ONE ``eval_full`` (the eigensolve that gives
f, c and the gradients also refreshes the eigen model, so a rejected step
pays nothing extra), updates the QN and then accepts or rejects, resizes
the radius and adapts the penalties as `FusedTR` does.

The problem gives ``eval_full(x) -> (f, c [ncon], g, A [ncon, n], M [N, N],
Minv, h [N, n])`` with constraint row ``index`` the eigenvalue aggregate
and (M, Minv, h) its curvature model at x (`models.fem_frequency`).  A
problem that opts in to warm starts (a ``supports_eig_warm_start``
attribute, or an ``eval_full`` parameter named ``V0``) returns the
eigenbasis V as an 8th value; the state carries it and every eigensolve
after the first starts from the last trial's basis, kept whenever finite.

The JAX package runs the whole loop as one ``lax.while_loop``; here it is
a host loop reading ``converged`` once per outer iteration, and the inner
solves and the problem's eigensolver read the device as `FusedTR`'s do
(``FusedEigenTR.syncs``, shared with the problem's own ``syncs`` counter
when it has one, counts them all).  ``eig_row_model='quadratic'`` gives
the inner QP the quadratic model of the eigen row; the steering solve
follows ``tr_adaptive_constraint``.
"""

from __future__ import annotations

import dataclasses
import functools
import inspect
from typing import Any, Dict, NamedTuple, Optional

import torch

from .ip import HostSyncs
from .ip_fused import _Run
from .ops import qn as qnmod
from .ops.kkt import ProblemData
from .parallel.sharding import spmd
from .tr import (FusedTROptions, QPParams, _add_row, _fused_ip_options,
                 _inner_solve, _qp_Bp, _tr_kkt, _tr_penalties, _tr_radius,
                 _tr_rho, _viol, make_qp_model)
from .tree import pytree, tmap
from .utils.options import make_options
from .utils.spans import span

__all__ = ["FusedEigenTR", "EigModel", "FusedEigTRState"]


class EigModel(NamedTuple):
    """The low-rank quadratic model of the eigen row at xk:
    c(xk + p) ≈ ck[index] + Ak[index]·p + 1/2 (h p)ᵀ M (h p); its linear
    terms are the state's real (ck, Ak)."""
    M: Any             # [N, N] curvature (NSD for KS aggregates)
    Minv: Any          # [N, N] regularized inverse
    h: Any             # [N, n] eigenvalue sensitivity stack


@pytree
@dataclasses.dataclass(frozen=True)
class FusedEigTRState:
    xk: torch.Tensor
    fk: torch.Tensor
    ck: torch.Tensor            # real constraint values at xk
    gk: torch.Tensor
    Ak: torch.Tensor            # real constraint gradients at xk
    qn: Optional[qnmod.QNState]
    eig: EigModel
    z0: torch.Tensor            # eigen-constraint multiplier estimate
    tr_size: torch.Tensor
    gamma: torch.Tensor
    k: torch.Tensor             # outer iteration counter (int32)
    subiters: torch.Tensor      # cumulative inner IP iterations (int32)
    converged: torch.Tensor     # bool
    infeas: torch.Tensor
    l1: torch.Tensor
    linf: torch.Tensor
    rho: torch.Tensor
    # the eigenbasis that warm-starts the next eigensolve (None when the
    # problem does not opt in)
    V: Optional[torch.Tensor] = None


def _merged_compact(qn, eig: EigModel, z0, dt):
    """(b0, Z, M) with B = b0 I − Zᵀ M⁻¹ Z merging the objective QN with
    the z0-scaled constraint curvature (`getCompactMat`,
    `ParOptCompactEigenvalueApprox.cpp:246-318`, z0 → 0 convention)."""
    nz = z0 != 0.0
    z0inv = torch.where(nz, 1.0 / torch.where(nz, z0, 1.0), 1.0)
    Me = z0inv * eig.Minv
    if qn is not None:
        b0, Zq, Mq = qnmod.qn_compact(qn)
        Z = torch.cat([Zq.to(dt), eig.h], dim=0)
        return b0, Z, torch.block_diag(Mq.to(dt), Me)
    return torch.zeros((), dtype=dt, device=Me.device), eig.h, Me


class _EigHead(NamedTuple):
    """An outer eigen-TR iteration up to its inner solves."""
    lk: torch.Tensor         # the trust-region box about xk
    uk: torch.Tensor
    p0: torch.Tensor         # the inner solves' start
    params: QPParams         # the QP model with the merged compact
    gamma_s: torch.Tensor    # the QP solve's elastic penalties


def _eig_head(to: FusedTROptions, lbv, ubv, state: FusedEigTRState):
    """The trust-region box and the merged-compact QP model."""
    xk, eig = state.xk, state.eig
    dt, dev = xk.dtype, xk.device
    idx = torch.arange(state.ck.shape[0], device=dev)
    lk = torch.maximum(-state.tr_size, lbv - xk)
    uk = torch.minimum(state.tr_size, ubv - xk)
    b0, Z, M = _merged_compact(state.qn, eig, state.z0, dt)
    one = torch.ones((), dtype=dt, device=dev)
    params = QPParams(fk=state.fk, gk=state.gk, ck=state.ck, Ak=state.Ak,
                      cwk=torch.zeros(0, dtype=dt, device=dev),
                      Aw_cols=None, Aw_vals=None, b0=b0, Z=Z, M=M,
                      obj_scale=one, eig_M=eig.M, eig_h=eig.h)
    return _EigHead(lk=lk, uk=uk, p0=0.5 * (lk + uk), params=params,
                    gamma_s=torch.where(idx < to.ninequality, 0.0,
                                        state.gamma))


def _c_model(index: int, state: FusedEigTRState, p):
    """The constraint model: linear rows, the eigen row's curvature term
    added (the host EigenSubproblem's model)."""
    eig = state.eig
    hp = eig.h @ p
    return _add_row(state.ck + state.Ak @ p, index,
                    0.5 * torch.dot(hp, eig.M @ hp))


def _eig_mid(index: int, nineq: int, state: FusedEigTRState,
             params: QPParams, p_inf, p):
    """After the inner solves: the steering step's best infeasibility (the
    same quadratic eigen-row model on both sides of the adaptive-gamma
    test), the model at the QP step, and the trial point."""
    best = (torch.zeros_like(state.ck) if p_inf is None
            else _viol(_c_model(index, state, p_inf), nineq))
    cm = _c_model(index, state, p)
    fm = (state.fk + torch.dot(state.gk, p)
          + 0.5 * torch.dot(p, _qp_Bp(params, p)))
    return best, cm, fm, state.xk + p


def _eig_tail(to: FusedTROptions, index: int, lbv, ubv,
              state: FusedEigTRState, best_con_infeas, cm, fm, p, z,
              iters, ft, ct, gt, At, Mt, Minvt, ht, Vt) -> FusedEigTRState:
    """The outer iteration after its trial evaluation: the QN update,
    acceptance and the radius, the eigen model and multiplier refresh, the
    penalties and the KKT error."""
    xk, fk, ck, gk, Ak = state.xk, state.fk, state.ck, state.gk, state.Ak
    eig = state.eig
    xt = xk + p
    # z must be finite too: a failed inner QP can return a finite p with a
    # NaN z, which would poison the QN pair and the multiplier refresh
    trial_finite = (torch.isfinite(ft) & torch.all(torch.isfinite(ct))
                    & torch.all(torch.isfinite(gt))
                    & torch.all(torch.isfinite(p))
                    & torch.all(torch.isfinite(ht))
                    & torch.all(torch.isfinite(z)))

    qn_new = state.qn
    if state.qn is not None:
        with span("paropt.tr.qn_update"):
            # the Lagrangian's secant pair with the REAL gradients
            # (`ParOptEigenSubproblem::acceptTrialStep`)
            y = (gt - At.T @ z) - (gk - Ak.T @ z)
            qn_new, _, _ = qnmod.qn_update(state.qn, p, y,
                                           accept=trial_finite)

    rho = _tr_rho(to, state.gamma, fk, fm, ft, ck, cm, ct)
    # a NaN rho fails both radius tests and would freeze the radius at a
    # rejected step: any non-finite trial or NaN rho counts as -inf
    rho = torch.where(trial_finite & ~torch.isnan(rho), rho, -float("inf"))
    accepted, tr_n = _tr_radius(to, state.tr_size, rho, trial_finite)

    def sel(a, b):
        return torch.where(accepted, a, b)

    xk_n, fk_n, ck_n = sel(xt, xk), sel(ft, fk), sel(ct, ck)
    gk_n, Ak_n = sel(gt, gk), sel(At, Ak)
    eig_n = EigModel(M=sel(Mt, eig.M), Minv=sel(Minvt, eig.Minv),
                     h=sel(ht, eig.h))
    # the multiplier refresh on accept (`update_multipliers`,
    # `ParOptCompactEigenvalueApprox.cpp:183`)
    z0_n = sel(z[index], state.z0)

    gamma_n = state.gamma
    if to.adaptive_gamma:
        gamma_n = _tr_penalties(to, gamma_n, z, ck, cm, best_con_infeas)

    # -- KKT error with the real gradients (`computeKKTError`) --------------
    zmax = torch.clamp(torch.max(torch.abs(z)), min=1.0)
    l1, linf, infeas_new, converged = _tr_kkt(
        to, lbv, ubv, xk_n, gk_n, gk_n - Ak_n.T @ z, zmax, ct)

    # the trial basis is a good warm start even on rejection (the trial
    # point is near xk): carry it whenever it is finite
    V_n = None
    if state.V is not None:
        V_n = torch.where(torch.all(torch.isfinite(Vt)), Vt, state.V)

    return FusedEigTRState(
        xk=xk_n, fk=fk_n, ck=ck_n, gk=gk_n, Ak=Ak_n, qn=qn_new, eig=eig_n,
        z0=z0_n, tr_size=tr_n, gamma=gamma_n, k=state.k + 1,
        subiters=state.subiters + iters, converged=converged,
        infeas=infeas_new, l1=l1, linf=linf, rho=rho, V=V_n)


def _fused_eig_tr_step(eval_full, eval_full_batched, qp_model, inf_model,
                       qp_opts, inf_opts, to: FusedTROptions, index: int,
                       lbv, ubv, d_tmpl: ProblemData,
                       state: FusedEigTRState, host=bool,
                       run: Optional[_Run] = None) -> FusedEigTRState:
    """One fused eigen-TR outer iteration (`sl1qpOptimize`'s body with the
    `ParOptEigenSubproblem` model); ``host`` reads a device flag (the inner
    solves' reads).  A batched ``run`` steps k instances: the inner solves
    batched and the trial priced by ``eval_full_batched``."""
    R = run or _Run(host)
    dt, dev = state.xk.dtype, state.xk.device
    ncon = d_tmpl.ncon
    nineq = to.ninequality
    idx = torch.arange(ncon, device=dev)
    head = R.call(functools.partial(_eig_head, to, lbv, ubv), (0,), state)
    params = head.params
    frozen = state.converged if R.batched else None
    # the instance axes of the inner solves' data: the box is per instance
    none = tmap(lambda _: None, d_tmpl)

    # -- steering infeasibility solve (`minimizeInfeas`) --------------------
    p_inf = None
    inf_iters = torch.zeros((), dtype=torch.int32, device=dev)
    if to.adaptive_gamma:
        gamma_big = max(1e6, 1e2 * to.gamma_max)
        inf_params = params._replace(
            obj_scale=torch.full_like(params.obj_scale, 1.0 / gamma_big))
        ones = torch.ones(ncon, dtype=dt, device=dev)
        d_inf = dataclasses.replace(
            d_tmpl, lb=head.lk, ub=head.uk,
            gamma_s=torch.where(idx < nineq, 0.0, ones), gamma_t=ones)
        with span("paropt.tr.steer"):
            st_inf = _inner_solve(inf_model, inf_opts, R, head.p0, d_inf,
                                  dataclasses.replace(none, lb=0, ub=0),
                                  inf_params, None, frozen)
        p_inf, inf_iters = st_inf.vars.x, st_inf.k

    # -- QP subproblem with the merged Hessian -------------------------------
    d_qp = dataclasses.replace(d_tmpl, lb=head.lk, ub=head.uk,
                               gamma_s=head.gamma_s, gamma_t=state.gamma)
    with span("paropt.tr.qp"):
        st = _inner_solve(qp_model, qp_opts, R, head.p0, d_qp,
                          dataclasses.replace(none, lb=0, ub=0, gamma_s=0,
                                              gamma_t=0),
                          params, (params.b0, params.Z, params.M), frozen)
    p, z = st.vars.x, st.vars.z

    # -- the model at the step; the eigen row's model value is quadratic ----
    best, cm, fm, xt = R.call(
        functools.partial(_eig_mid, index, nineq),
        (0, 0, None if p_inf is None else 0, 0), state, params, p_inf, p)

    # -- trial evaluation: one eval_full prices the trial and refreshes the
    #    eigen model; state.V warm-starts the eigensolve ---------------------
    with span("paropt.tr.eval"):
        trial = (eval_full_batched if R.batched else eval_full)(xt, state.V)
    return R.call(functools.partial(_eig_tail, to, index, lbv, ubv),
                  (0,) * (7 + len(trial)), state, best, cm, fm, p, z,
                  st.k + inf_iters, *trial)


def _wants_warm_start(problem) -> bool:
    """The explicit warm-start opt-in: a ``supports_eig_warm_start``
    attribute, or an ``eval_full`` parameter named ``V0``."""
    if getattr(problem, "supports_eig_warm_start", False):
        return True
    try:
        return "V0" in inspect.signature(problem.eval_full).parameters
    except (TypeError, ValueError):
        return False


class FusedEigenTR:
    """The fused eigenvalue-constrained SL1QP trust region for a problem
    with ``eval_full`` (see the module docstring), dense constraints only
    (``nwcon == 0``), the eigen constraint at row ``index``, on the
    problem's device.  Options use the tr_* and IP registry names;
    ``qn_b0`` seeds the objective QN diagonal.  Constructing a solver turns
    TF32 off for float32 matrix products, as `FusedTR` does."""

    def __init__(self, problem, options: Optional[Dict[str, Any]] = None,
                 index: int = 0, qn_b0: float = 1.0,
                 eig_row_model: str = "linear"):
        if problem.nwcon:
            raise ValueError("FusedEigenTR supports dense constraints only")
        if eig_row_model not in ("quadratic", "linear"):
            raise ValueError(f"eig_row_model must be 'quadratic' or "
                             f"'linear', got {eig_row_model!r}")
        o = options if hasattr(options, "descriptors") else \
            make_options(options or {}, which="facade")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dt = torch.float64 if o["dtype"] == "float64" else torch.float32
        x0, lb, ub = problem.get_vars_and_bounds()
        dev = x0.device
        kw = dict(dtype=dt, device=dev)
        x0, lbv, ubv = x0.to(dt), lb.to(dt), ub.to(dt)
        n, ncon = problem.nvars, problem.ncon
        warm = _wants_warm_start(problem)

        def cast(out, V, *kb):
            f, c, g, A, M, Minv, h = out[:7]
            return (f.to(dt), c.to(dt).reshape(*kb, ncon), g.to(dt),
                    A.to(dt).reshape(*kb, ncon, n), M.to(dt), Minv.to(dt),
                    h.to(dt), out[7] if warm else V)

        def eval_full(x, V=None):
            return cast(problem.eval_full(x, V) if warm
                        else problem.eval_full(x), V)

        # k instances priced at once: the problem's own batched evaluation
        # (the frequency models' batched eigensolve, whose host reads
        # cannot run under vmap), else eval_full under torch.func.vmap
        batched = getattr(problem, "eval_full_batched", None)

        def eval_full_batched(xs, V=None):
            if batched is not None:
                out = batched(xs, V) if warm else batched(xs)
            else:
                out = _Run(None, batched=True).call(
                    eval_full, (0, None if V is None else 0), xs, V)
            return cast(out, V, xs.shape[0])

        eig_idx = index if eig_row_model == "quadratic" else None
        qp_model = make_qp_model(False, "quadratic", eig_index=eig_idx)
        obj_mode = {"linear_objective": "linear",
                    "constant_objective": "linear",
                    "subproblem_objective": "quadratic"}[
                        o["tr_adaptive_objective"]]
        inf_eig_idx = (eig_idx if o["tr_adaptive_constraint"]
                       == "subproblem_constraint" else None)
        inf_model = make_qp_model(False, obj_mode, eig_index=inf_eig_idx)

        ones = torch.ones(n, **kw)
        d_tmpl = ProblemData(
            g=torch.zeros(n, **kw), A=torch.zeros((ncon, n), **kw),
            c=torch.zeros(ncon, **kw), cw=torch.zeros(0, **kw),
            lb=lbv, ub=ubv, lb_mask=ones, ub_mask=ones,
            gamma_s=torch.zeros(ncon, **kw), gamma_t=torch.zeros(ncon, **kw),
            gamma_sw=torch.zeros(0, **kw), gamma_tw=torch.zeros(0, **kw),
            Aw_cols=None, Aw_vals=None, nwblock=1, Aw_layout="gather")

        slm = (o["tr_adaptive_objective"] in ("linear_objective",
                                              "constant_objective")
               and o["tr_adaptive_constraint"] == "linear_constraint")
        qp_opts = _fused_ip_options(o, o["barrier_strategy"],
                                    o["starting_point_strategy"], False)
        inf_opts = _fused_ip_options(
            o, o["tr_steering_barrier_strategy"],
            o["tr_steering_starting_point_strategy"], slm)
        gamma = o["penalty_gamma"]
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
            ninequality=problem.ninequality, nwinequality=0)

        qn0 = None
        msub = qnmod.resolve_subspace_size(
            o["qn_subspace_size"], o["qn_subspace_auto"], n, dt)
        if o["qn_type"] != "none" and msub > 0:
            from .ip import _resolve_qn_storage
            qn0 = qnmod.qn_init(
                msub, n, dtype=dt, qn_type=o["qn_type"], b0=qn_b0,
                storage_dtype=_resolve_qn_storage(o["qn_storage_dtype"], dt),
                update_type=o["qn_update_type"],
                diag_type=o["qn_diag_type"], device=dev)

        # the problem's eigensolver reads are counted with the solver's
        self.syncs = getattr(problem, "syncs", None) or HostSyncs()
        f0, c0, g0, A0, M0, Minv0, h0, V0 = eval_full(x0)
        zero = torch.zeros((), **kw)
        self._state0 = FusedEigTRState(
            xk=x0, fk=f0, ck=c0, gk=g0, Ak=A0, qn=qn0,
            eig=EigModel(M=M0, Minv=Minv0, h=h0),
            z0=zero, tr_size=zero + to.init_size,
            gamma=torch.full((ncon,), gamma, **kw),
            k=torch.zeros((), dtype=torch.int32, device=dev),
            subiters=torch.zeros((), dtype=torch.int32, device=dev),
            converged=torch.zeros((), dtype=torch.bool, device=dev),
            infeas=zero + float("inf"), l1=zero + float("inf"),
            linf=zero + float("inf"), rho=zero, V=V0)
        self._to = to
        self._index = index
        self._problem = problem
        self._write_freq = o["tr_write_output_frequency"]
        self._eval_full_batched = eval_full_batched
        self._step = functools.partial(
            _fused_eig_tr_step, eval_full, eval_full_batched, qp_model,
            inf_model, qp_opts, inf_opts, to, index, lbv, ubv, d_tmpl,
            host=self.syncs)

    @spmd
    def solve(self, state0: Optional[FusedEigTRState] = None,
              jit_loop: bool = True, chunk="auto", checkpoint_path=None):
        """Run the outer loop (paropt_tpu/eig_fused.py:458-488), reading
        ``converged`` after each outer iteration; returns (result dict,
        final state).  Pass a previous final state to resume.
        ``jit_loop`` / ``chunk`` as in `tr.FusedTR.solve`: by default the
        loop stops at the absolute count ``tr_max_iterations``, in windows
        sized by ``'auto'``; ``jit_loop=False`` runs ``tr_max_iterations``
        more outer iterations from the state given.  Nothing is compiled:
        the final state is the same under any chunk.  The problem's
        ``write_output(it, x)`` fires every ``tr_write_output_frequency``
        outer iterations at window boundaries, and ``checkpoint_path`` gets
        the full state at the same cadence (`utils.checkpoint`).  A
        ``state0`` placed on a device mesh (`parallel.sharding.shard_tree`)
        runs sharded: the QP and the QN update on DTensors, the problem's
        ``eval_full`` on its x-strips (`parallel.halo`)."""
        from .utils.chunked import (host_reader, make_write_output_hook,
                                    outer_loop, user_write_output)
        hook = make_write_output_hook(user_write_output(self._problem),
                                      self._write_freq,
                                      checkpoint_path=checkpoint_path,
                                      syncs=self.syncs)
        state = state0 if state0 is not None else self._state0
        state = outer_loop(self._step, lambda st: self.syncs(st.converged),
                           state, self._to.max_iterations, jit_loop, chunk,
                           on_chunk=hook, read=host_reader(self.syncs))
        result = {"x": state.xk, "fobj": float(state.fk),
                  "converged": bool(state.converged), "niter": int(state.k),
                  "infeas": float(state.infeas), "l1": float(state.l1),
                  "linfty": float(state.linf),
                  "tr_size": float(state.tr_size),
                  "subiters": int(state.subiters)}
        return result, state

    def solve_batched(self, x0_batch, chunk="auto"):
        """k multi-start solves as one (paropt_tpu/eig_fused.py:490-525):
        each instance's initial model (f, c, g, A, the eigen model M, Minv,
        h and its basis V at its x0) comes from one batched evaluation, the
        outer step's phases and inner solves run under ``torch.func.vmap``,
        each trial is priced by one batched eigensolve, and each instance
        keeps its own warm-start basis.  One host read of "every instance
        converged" per outer iteration; an instance that has converged
        keeps its state bit for bit while the others iterate.

        ``x0_batch``: [k, n] starting points.  ``chunk``: the windows of
        `utils.chunked.run_chunked_batched` (an int, ``'auto'`` or None);
        the result is the same under any.  Returns (results, states):
        ``results`` holds per-instance numpy arrays of fobj, converged,
        niter, infeas, l1 and linfty (and x [k, n]); ``states`` is the
        `FusedEigTRState` with a leading k axis."""
        from .utils.chunked import (batch_reader, run_chunked_batched,
                                    step_until)
        run = _Run(self.syncs, batched=True)
        s0 = self._state0
        x0_batch = torch.as_tensor(x0_batch, dtype=s0.xk.dtype,
                                   device=s0.xk.device)
        f0, c0, g0, A0, M0, Minv0, h0, V0 = self._eval_full_batched(
            x0_batch, None)

        def start(st, x, f, c, g, A, M, Minv, h, V):
            return dataclasses.replace(
                st, xk=x, fk=f, ck=c, gk=g, Ak=A,
                eig=EigModel(M=M, Minv=Minv, h=h), V=V)

        state = run.call(start, (None,) + (0,) * 9, s0, x0_batch, f0, c0,
                         g0, A0, M0, Minv0, h0, V0)

        def step(st):
            return run.freeze(st.converged, self._step(st, run=run), st)

        state = run_chunked_batched(
            lambda st, k, k_stop: step_until(
                step, lambda s: run.all(s.converged), st, k, k_stop),
            state, self._to.max_iterations, chunk,
            read=batch_reader(self.syncs))
        results = {"x": state.xk,
                   **{key: getattr(state, f).cpu().numpy() for key, f in (
                       ("fobj", "fk"), ("converged", "converged"),
                       ("niter", "k"), ("infeas", "infeas"), ("l1", "l1"),
                       ("linfty", "linf"))}}
        return results, state
