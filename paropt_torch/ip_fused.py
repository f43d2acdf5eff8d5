"""Fused interior-point major iteration (counterpart of
paropt_tpu/ip_fused.py).

One step — residual + norms, the quasi-definite KKT factor and solve,
fraction-to-boundary scaling, the ρ-penalty update, the merit line search,
the variable update and the in-loop compact quasi-Newton update — is one
function of (state, data) -> state, as in the JAX package.  The JAX step is
one compiled computation; here it runs eagerly, and the line search's
``while_loop`` becomes a Python loop that reads its ``done`` flag on the
host (one device sync per trial).  ``FusedIP.syncs`` counts those reads and
the solve loop's convergence check.

Ported: all four barrier strategies, the least-squares and affine-step
starts, compact-QN / diagonal / fixed Hessians, the merit line search with
the ρ update, the in-loop QN update, the non-finite fail-stop and the
freeze once converged.  Not yet ported: the fused Newton-Krylov phase
(``use_hvec_product``), ``solve_batched`` and the chunked solve.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch
from torch.profiler import record_function

from .dtypes import resolve_dtype
from .ip import _barrier_terms, _infeas_l2
from .ops import kkt
from .ops import qn as qnmod
from .ops.kkt import IPVars, ProblemData
from .ops.veclib import dot, matmul, multi_norm
from .tree import tmap

__all__ = ["FusedIP", "FusedIPOptions", "FusedState", "ModelFns",
           "HostSyncs", "model_from_problem", "data_template_from_problem"]


@dataclasses.dataclass(frozen=True)
class ModelFns:
    """Pure-function problem definition; each callable takes
    (model_params, ...)."""
    eval_obj_con: Callable   # (params, x) -> (f, c[ncon], cw[nwcon])
    eval_grad: Callable      # (params, x) -> (g[n], A[ncon, n])
    hess_diag: Optional[Callable] = None  # (params, x, z, zw) -> h[n]
    hvp: Optional[Callable] = None        # (params, x, z, zw, px) -> H px


class FusedIPOptions(NamedTuple):
    """Solver options: the JAX package's fields and defaults, without the
    Newton-Krylov phase's."""
    abs_res_tol: float = 1e-6
    init_barrier_param: float = 0.1
    monotone_barrier_fraction: float = 0.25
    monotone_barrier_power: float = 1.1
    rel_bound_barrier: float = 1.0
    min_fraction_to_boundary: float = 0.95
    penalty_descent_fraction: float = 0.3
    min_rho_penalty_search: float = 0.0
    armijo_constant: float = 1e-5
    function_precision: float = 1e-10
    design_precision: float = 1e-14
    max_line_iters: int = 10
    use_backtracking_alpha: bool = False
    max_major_iters: int = 200
    iterative_refinement_steps: int = 1
    qn_sigma: float = 0.0
    # 'monotone'|'mehrotra'|'mehrotra_predictor_corrector'|
    # 'complementarity_fraction'
    barrier_strategy: str = "monotone"
    starting_point_strategy: str = "affine_step"
    start_affine_multiplier_min: float = 1.0
    use_line_search: bool = True
    use_quasi_newton_update: bool = False   # in-loop L-BFGS updates
    use_diag_hessian: bool = False          # B from model.hess_diag
    sequential_linear_method: bool = False  # B = qn_sigma
    norm_type: str = "infinity"
    # the fused Newton-Krylov phase is not ported yet: True raises
    # NotImplementedError (its GMRES options come with it)
    use_hvec_product: bool = False


@dataclasses.dataclass(frozen=True)
class FusedState:
    """Complete solver state."""
    vars: IPVars
    qn: Optional[qnmod.QNState]
    mu: torch.Tensor
    rho: torch.Tensor
    fobj: torch.Tensor
    c: torch.Tensor
    cw: torch.Tensor
    g: torch.Tensor
    A: torch.Tensor
    k: torch.Tensor                 # iteration counter (int32)
    converged: torch.Tensor         # bool
    res_norm: torch.Tensor
    comp: torch.Tensor
    fobj_prev: torch.Tensor
    line_search_test: torch.Tensor  # int32 consecutive no-improvement count
    neval: torch.Tensor             # int32
    alpha: torch.Tensor             # last accepted line-search step
    alpha_x: torch.Tensor
    alpha_z: torch.Tensor
    gmres_iters: torch.Tensor       # int32 NK iterations (always 0 here)


class HostSyncs:
    """Reads a 0-d bool tensor on the host and counts the reads: each one
    waits for the device."""

    def __init__(self):
        self.count = 0

    def __call__(self, flag: torch.Tensor) -> bool:
        self.count += 1
        return bool(flag)


def _norms(r: IPVars, norm_type: str):
    prime = multi_norm([r.x, r.s, r.t], norm_type)
    dual = multi_norm([r.zl, r.zu, r.zs, r.zt, r.sw, r.tw, r.zsw, r.ztw],
                      norm_type)
    infeas = multi_norm([r.z, r.zw], norm_type)
    if norm_type == "infinity":
        return torch.maximum(prime, torch.maximum(dual, infeas))
    if norm_type == "l1":
        return prime + dual + infeas
    return torch.sqrt(prime ** 2 + dual ** 2 + infeas ** 2)


class FusedIP:
    """The fused interior-point solver.

    Parameters: ``model`` (ModelFns), the problem sizes ``n``, ``ncon``,
    ``nwcon``, ``nwblock``, ``opts`` (FusedIPOptions) and ``dtype``.
    Constructing a solver turns TF32 off for float32 matrix products and
    convolutions: the solver's algebra needs full float32."""

    def __init__(self, model: ModelFns, n: int, ncon: int, nwcon: int = 0,
                 nwblock: int = 1, opts: FusedIPOptions = FusedIPOptions(),
                 dtype=None):
        if opts.use_hvec_product:
            raise NotImplementedError(
                "the fused Newton-Krylov phase (use_hvec_product) is not "
                "ported yet")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.model = model
        self.n, self.ncon, self.nwcon = n, ncon, nwcon
        self.nwblock = nwblock
        self.opts = opts
        self.dtype = resolve_dtype(dtype)
        self.syncs = HostSyncs()

    def init(self, x0, data: ProblemData, model_params,
             qn_state: Optional[qnmod.QNState], compact) -> FusedState:
        """Initialize state (bounds clipping, multiplier start strategy)."""
        return _fused_init(self.model, self.opts, x0, data, model_params,
                           qn_state, compact)

    def step(self, state: FusedState, data: ProblemData, model_params,
             compact) -> FusedState:
        return _fused_step(self.model, self.opts, state, data, model_params,
                           compact, host=self.syncs)

    def solve(self, x0, data: ProblemData, model_params,
              qn_state: Optional[qnmod.QNState] = None, compact=None,
              max_iters: Optional[int] = None, on_chunk=None,
              chunk=None) -> FusedState:
        """Run to convergence: a host loop over steps that reads
        ``converged`` after each one."""
        if on_chunk is not None or chunk is not None:
            raise NotImplementedError("the chunked solve is not ported yet")
        state = self.init(x0, data, model_params, qn_state, compact)
        for _ in range(max_iters or self.opts.max_major_iters):
            state = self.step(state, data, model_params, compact)
            if self.syncs(state.converged):
                break
        return state

    def solve_batched(self, *args, **kwargs):
        raise NotImplementedError("solve_batched is not ported yet")


# ---------------------------------------------------------------------------
# implementation
# ---------------------------------------------------------------------------


def _refresh_data(d: ProblemData, g, A, c, cw) -> ProblemData:
    return dataclasses.replace(d, g=g, A=A, c=c, cw=cw)


def _bound_pads(d: ProblemData, dprec, dtype):
    """Distance the clips keep x STRICTLY inside [lb, ub]: at least a few
    ulps of the bound's magnitude, since design_precision (1e-14) is below
    f32 resolution and a clip to lb + 1e-14 would leave x ON the bound."""
    eps = torch.finfo(dtype).eps
    lo = torch.clamp(4.0 * eps * (1.0 + torch.abs(d.lb)), min=dprec)
    hi = torch.clamp(4.0 * eps * (1.0 + torch.abs(d.ub)), min=dprec)
    return lo, hi


def _get_compact(opts: FusedIPOptions, model: ModelFns, state: FusedState,
                 model_params, compact):
    """Resolve the Hessian representation for this iteration."""
    if opts.use_diag_hessian:
        h = model.hess_diag(model_params, state.vars.x, state.vars.z,
                            state.vars.zw)
        return (h, None, None)
    if opts.use_quasi_newton_update and state.qn is not None:
        return qnmod.qn_compact(state.qn)
    if compact is not None:
        return compact
    b0 = 0.0 if opts.sequential_linear_method else 1.0
    return (torch.tensor(b0, dtype=state.vars.x.dtype,
                         device=state.vars.x.device), None, None)


def _fused_init(model: ModelFns, opts: FusedIPOptions, x0, d: ProblemData,
                model_params, qn_state, compact) -> FusedState:
    dtype = x0.dtype
    dev = x0.device
    scalar = lambda val: torch.tensor(val, dtype=dtype, device=dev)
    lo_pad, hi_pad = _bound_pads(d, opts.design_precision, dtype)
    x = torch.where((d.lb_mask > 0) & (x0 < d.lb + lo_pad), d.lb + lo_pad, x0)
    x = torch.where((d.ub_mask > 0) & (x > d.ub - hi_pad), d.ub - hi_pad, x)

    ncon, nwcon = d.ncon, d.nwcon
    mu0 = opts.init_barrier_param

    fobj, c, cw = model.eval_obj_con(model_params, x)
    g, A = model.eval_grad(model_params, x)
    d = _refresh_data(d, g, A, c, cw)

    full_c = torch.full((ncon,), mu0, dtype=dtype, device=dev)
    full_w = torch.full((nwcon,), mu0, dtype=dtype, device=dev)
    # a tensor operand, not two Python scalars: torch.where(mask, 0.1, 0.0)
    # would be float32 whatever the solve's dtype
    full_n = torch.full_like(x, mu0)
    v = IPVars(
        x=x,
        zl=torch.where(d.lb_mask > 0, full_n, 0.0),
        zu=torch.where(d.ub_mask > 0, full_n, 0.0),
        s=full_c, t=full_c, z=full_c, zs=full_c, zt=full_c,
        sw=full_w, tw=full_w, zw=full_w, zsw=full_w, ztw=full_w)

    strategy = opts.starting_point_strategy
    if strategy in ("least_squares_multipliers", "affine_step"):
        # regularized least-squares multiplier estimate
        # (`initLeastSquaresMultipliers`, ParOptInteriorPoint.cpp:5336-5534)
        small = 1e-4
        rhs = -(g - v.zl + v.zu)
        if nwcon > 0:
            nb = d.nwblock
            eye = torch.eye(nb, dtype=dtype, device=dev)
            Cw = d.Aw_inner_blocks(torch.ones_like(x)) + small * eye
            Cw_chol = (torch.sqrt(Cw) if nb == 1
                       else torch.linalg.cholesky_ex(Cw).L)
        else:
            Cw_chol = None
        f0 = kkt.KKTFactor(Dinv=torch.ones_like(x), Gamma=None, C0=None,
                           Cw_chol=Cw_chol, Xa=None, Wa=None, G_lu=None,
                           Zqn=None, Phi_x=None, Phi_z=None, Phi_w=None,
                           Ce_inv=None)
        zw0 = torch.zeros(nwcon, dtype=dtype, device=dev)
        if ncon > 0:
            Xa, _ = kkt.quasi_def_solve(
                f0, d, d.A, torch.zeros((ncon, nwcon), dtype=dtype,
                                        device=dev))
            G = d.A @ Xa.T + small * torch.eye(ncon, dtype=dtype, device=dev)
            yx0, _ = kkt.quasi_def_solve(f0, d, rhs, zw0)
            z = torch.linalg.solve_ex(G, -(d.A @ yx0)).result
            gmax = 10.0 * torch.maximum(d.gamma_s, d.gamma_t)
            z = torch.where((z < -gmax) | (z > gmax), 0.0, z)
            v = dataclasses.replace(v, z=z)
        if nwcon > 0:
            rx = rhs + d.A.T @ v.z if ncon else rhs
            _, zw_neg = kkt.quasi_def_solve(f0, d, rx, zw0)
            zw = -zw_neg
            gwmax = 10.0 * torch.maximum(d.gamma_sw, d.gamma_tw)
            zw = torch.where((zw < -gwmax) | (zw > gwmax), 0.0, zw)
            v = dataclasses.replace(v, zw=zw)

    mu = scalar(mu0)
    if strategy == "affine_step":
        # one μ=0 Newton step; variables = |v + p| floored
        # (`initAffineStepMultipliers`, ParOptInteriorPoint.cpp:5536-5667)
        cq = compact if compact is not None else (
            scalar(0.0 if opts.sequential_linear_method else 1.0), None, None)
        if opts.use_diag_hessian and model.hess_diag is not None:
            cq = (model.hess_diag(model_params, x, v.z, v.zw), None, None)
        r = kkt.kkt_residual(v, d, scalar(0.0), opts.rel_bound_barrier)
        f = kkt.setup_kkt_factor(v, d, qn_compact=cq, qn_sigma=opts.qn_sigma)
        p = kkt.solve_kkt(v, d, f, r)
        amin = opts.start_affine_multiplier_min

        def aff(val, st, mask=None):
            out = torch.clamp(torch.abs(val + st), min=amin)
            if mask is not None:
                out = torch.where(mask > 0, out, 0.0)
            return out

        v = IPVars(
            x=v.x, zl=aff(v.zl, p.zl, d.lb_mask),
            zu=aff(v.zu, p.zu, d.ub_mask),
            s=aff(v.s, p.s), t=aff(v.t, p.t), z=v.z + p.z,
            zs=aff(v.zs, p.zs), zt=aff(v.zt, p.zt),
            sw=aff(v.sw, p.sw), tw=aff(v.tw, p.tw), zw=v.zw + p.zw,
            zsw=aff(v.zsw, p.zsw), ztw=aff(v.ztw, p.ztw))
        mu = kkt.average_complementarity(v, d)

    r = kkt.kkt_residual(v, d, mu, opts.rel_bound_barrier)
    zero = scalar(0.0)
    zero_i = torch.zeros((), dtype=torch.int32, device=dev)
    return FusedState(
        vars=v, qn=qn_state, mu=mu, rho=zero + opts.min_rho_penalty_search,
        fobj=fobj, c=c, cw=cw, g=g, A=A, k=zero_i,
        converged=torch.zeros((), dtype=torch.bool, device=dev),
        res_norm=_norms(r, opts.norm_type),
        comp=kkt.average_complementarity(v, d),
        fobj_prev=fobj, line_search_test=zero_i, neval=zero_i + 1,
        alpha=zero + 1.0, alpha_x=zero + 1.0, alpha_z=zero + 1.0,
        gmres_iters=zero_i)


def _merit_fn(opts: FusedIPOptions, d: ProblemData, x, s, t, sw, tw, fobj,
              c, cw, mu, rho):
    return (fobj + torch.sum(d.gamma_s * s) + torch.sum(d.gamma_t * t)
            + torch.sum(d.gamma_sw * sw) + torch.sum(d.gamma_tw * tw)
            - mu * _barrier_terms(x, s, t, sw, tw, d, opts.rel_bound_barrier)
            + rho * _infeas_l2(c, s, t, cw, sw, tw))


def _clip(x, lo, hi):
    """jnp.clip with tensor bounds: min(max(x, lo), hi)."""
    return torch.minimum(torch.maximum(x, lo), hi)


def _neg_or(x, fill=-1.0):
    """x where x < 0, else ``fill`` (a safe denominator)."""
    return torch.where(x < 0.0, x, fill)


def _fused_step(model: ModelFns, opts: FusedIPOptions, state: FusedState,
                d: ProblemData, model_params, compact,
                host: Callable[[torch.Tensor], bool] = bool) -> FusedState:
    """One full major iteration.  ``host`` reads a device flag on the host
    (the line search's ``done``)."""
    v = state.vars
    dtype = v.x.dtype
    dev = v.x.device
    zero_i = torch.zeros((), dtype=torch.int32, device=dev)
    d = _refresh_data(d, state.g, state.A, state.c, state.cw)
    tol = opts.abs_res_tol
    rbb = opts.rel_bound_barrier

    # -- factorization (μ-independent) --------------------------------------
    comp = kkt.average_complementarity(v, d)
    cq = _get_compact(opts, model, state, model_params, compact)
    # record_function ranges label the phases in torch.profiler traces
    # (the counterpart of the JAX step's named scopes)
    with record_function("paropt.kkt_factor"):
        f = kkt.setup_kkt_factor(v, d, qn_compact=cq, qn_sigma=opts.qn_sigma)

    # the KKT residual is affine in μ: compute it once at μ = 0 and shift
    r00 = kkt.kkt_residual(v, d, torch.zeros((), dtype=dtype, device=dev),
                           rbb)

    def _residual_at(m):
        return dataclasses.replace(
            r00, zs=r00.zs - m, zt=r00.zt - m, zsw=r00.zsw - m,
            ztw=r00.ztw - m,
            zl=torch.where(d.lb_mask > 0, r00.zl - rbb * m, 0.0),
            zu=torch.where(d.ub_mask > 0, r00.zu - rbb * m, 0.0))

    # -- barrier strategy ----------------------------------------------------
    ls_base = state.line_search_test
    p_aff_s = None
    if opts.barrier_strategy == "complementarity_fraction":
        mu = torch.clamp(opts.monotone_barrier_fraction * comp, min=0.1 * tol)
    elif opts.barrier_strategy in ("mehrotra",
                                   "mehrotra_predictor_corrector"):
        # affine predictor toward μ = 0 from the same factorization
        p_aff = kkt.solve_kkt(v, d, f, r00, qn_compact=cq)
        ax_a, az_a = kkt.max_step_lengths(
            v, d, p_aff, torch.ones((), dtype=dtype, device=dev))
        ax_a = torch.clamp(ax_a, max=1.0)
        az_a = torch.clamp(az_a, max=1.0)
        comp_aff = kkt.average_complementarity(v.axpy(ax_a, az_a, p_aff), d)
        sigma = torch.clamp((comp_aff / torch.clamp(comp, min=1e-300)) ** 3,
                            min=0.01)
        # keep the barrier non-increasing
        mu = torch.minimum(
            torch.clamp(sigma * comp, min=0.09999 * tol), state.mu)
        if opts.barrier_strategy == "mehrotra_predictor_corrector":
            p_aff_s = p_aff.scaled(ax_a, az_a)
    else:  # monotone
        res0 = _norms(_residual_at(state.mu), opts.norm_type)
        barrier_conv = (state.k > 0) & ((res0 < 10.0 * state.mu)
                                        | (state.line_search_test >= 2))
        new_mu = torch.minimum(opts.monotone_barrier_fraction * state.mu,
                               state.mu ** opts.monotone_barrier_power)
        new_mu = torch.clamp(new_mu, min=0.09999 * tol)
        mu = torch.where(barrier_conv, new_mu, state.mu)
        # a new barrier problem resets the no-improvement counter
        ls_base = torch.where(barrier_conv & (state.mu > 0.1 * tol),
                              zero_i, state.line_search_test)

    r = _residual_at(mu)
    res_norm = _norms(r, opts.norm_type)
    if p_aff_s is not None:
        # corrector: second-order Δ·Δ complementarity terms
        r = dataclasses.replace(
            r,
            zs=r.zs + p_aff_s.s * p_aff_s.zs,
            zt=r.zt + p_aff_s.t * p_aff_s.zt,
            zsw=r.zsw + p_aff_s.sw * p_aff_s.zsw,
            ztw=r.ztw + p_aff_s.tw * p_aff_s.ztw,
            zl=torch.where(d.lb_mask > 0, r.zl + p_aff_s.x * p_aff_s.zl, 0.0),
            zu=torch.where(d.ub_mask > 0, r.zu - p_aff_s.x * p_aff_s.zu,
                           0.0))

    converged = (state.k > 0) & (mu <= 0.1 * tol) & (
        (res_norm < tol) | (state.line_search_test >= 2))

    # -- KKT step -----------------------------------------------------------
    with record_function("paropt.kkt_solve"):
        p = kkt.solve_kkt(v, d, f, r,
                          refine_steps=opts.iterative_refinement_steps,
                          qn_compact=cq)

    # -- fraction-to-boundary scaling ---------------------------------------
    tau = torch.clamp(1.0 - mu, min=opts.min_fraction_to_boundary)
    ax, az = kkt.max_step_lengths(v, d, p, tau)
    mb = 100.0
    ax = torch.where(ax > az, _clip(ax, az / mb, az * mb), ax)
    az = torch.where(az > ax, _clip(az, ax / mb, ax * mb), az)
    comp_new = kkt.average_complementarity(v.axpy(ax, az, p), d)
    amin2 = torch.minimum(ax, az)
    ceq = comp_new > 10.0 * comp
    ax = torch.where(ceq, amin2, ax)
    az = torch.where(ceq, amin2, az)
    ps = p.scaled(ax, az)

    # -- merit + rho update -------------------------------------------------
    merit0 = (state.fobj + torch.sum(d.gamma_s * v.s)
              + torch.sum(d.gamma_t * v.t) + torch.sum(d.gamma_sw * v.sw)
              + torch.sum(d.gamma_tw * v.tw)
              - mu * _barrier_terms(v.x, v.s, v.t, v.sw, v.tw, d, rbb))
    pbarrier = rbb * (
        torch.sum(torch.where(d.lb_mask > 0, ps.x / (v.x - d.lb), 0.0))
        - torch.sum(torch.where(d.ub_mask > 0, ps.x / (d.ub - v.x), 0.0)))
    for val, st in ((v.s, ps.s), (v.t, ps.t), (v.sw, ps.sw), (v.tw, ps.tw)):
        if val.numel():
            pbarrier = pbarrier + torch.sum(st / val)
    pmerit0 = (dot(d.g, ps.x)
               + torch.sum(d.gamma_s * ps.s) + torch.sum(d.gamma_t * ps.t)
               + torch.sum(d.gamma_sw * ps.sw) + torch.sum(d.gamma_tw * ps.tw)
               - mu * pbarrier)
    infeas = _infeas_l2(d.c, v.s, v.t, d.cw, v.sw, v.tw)
    proj = torch.zeros((), dtype=dtype, device=dev)
    if d.ncon:
        proj = proj + torch.sum((d.c - v.s + v.t)
                                * (d.A @ ps.x - ps.s + ps.t))
    if d.nwcon:
        proj = proj + torch.sum((d.cw - v.sw + v.tw)
                                * (d.Aw_matvec(ps.x) - ps.sw + ps.tw))
    infeas_proj = torch.where(infeas > 0.0,
                              proj / torch.clamp(infeas, min=1e-300), 0.0)
    b0c, Zc, Mc = cq
    Bpx = b0c * ps.x
    if Zc is not None:
        Bpx = Bpx - matmul(Zc.T,
                           torch.linalg.solve_ex(Mc, matmul(Zc, ps.x)).result)
    pTBp = dot(ps.x, Bpx)

    # ρ update (evalMeritInitDeriv tail)
    descent = opts.penalty_descent_fraction
    numer = pmerit0 + torch.where(pTBp > 0.0, 0.5 * pTBp, 0.0)
    small_inf = infeas < 0.1 * tol
    denom_small = -(1.0 - descent) * ax * infeas
    rho_small = torch.where((numer >= 0.0) & (denom_small < 0.0),
                            -numer / _neg_or(denom_small), 0.0)
    denom_big = infeas_proj + descent * ax * infeas
    rho_big = torch.where(
        numer >= 0.0,
        torch.where(denom_big < 0.0, -numer / _neg_or(denom_big),
                    torch.where(denom_small < 0.0,
                                -numer / _neg_or(denom_small), 0.0)),
        0.0)
    rho_hat = torch.where(small_inf, rho_small, rho_big)
    rho = torch.where(rho_hat > state.rho, rho_hat,
                      torch.maximum(0.5 * state.rho, rho_hat))
    rho = torch.clamp(rho, min=opts.min_rho_penalty_search)
    m0 = merit0 + rho * infeas
    dm0 = torch.where(small_inf, pmerit0 - rho * ax * infeas,
                      pmerit0 + rho * infeas_proj)

    # -- line search --------------------------------------------------------
    fprec = opts.function_precision
    dprec = opts.design_precision
    lo_pad, hi_pad = _bound_pads(d, dprec, dtype)

    def clip_x(xt):
        xt = torch.where((d.lb_mask > 0) & (xt <= d.lb + lo_pad),
                         d.lb + lo_pad, xt)
        return torch.where((d.ub_mask > 0) & (xt + hi_pad >= d.ub),
                           d.ub - hi_pad, xt)

    def floor(a):
        return torch.clamp(a, min=dprec)

    @record_function("paropt.line_search_trial")
    def trial(alpha):
        xt = clip_x(v.x + alpha * ps.x)
        ft, ct, cwt = model.eval_obj_con(model_params, xt)
        return _merit_fn(opts, d, xt, floor(v.s + alpha * ps.s),
                         floor(v.t + alpha * ps.t),
                         floor(v.sw + alpha * ps.sw),
                         floor(v.tw + alpha * ps.tw), ft, ct, cwt, mu, rho)

    one = torch.ones((), dtype=dtype, device=dev)
    if opts.use_line_search:
        px_norm = torch.max(torch.abs(ps.x))
        alpha_min = torch.clamp(
            torch.where(px_norm > 0,
                        fprec / torch.clamp(px_norm, min=1e-300), 1.0),
            max=0.5)
        alpha = one
        best_a = -one
        best_m = torch.zeros((), dtype=dtype, device=dev)
        success = torch.zeros((), dtype=torch.bool, device=dev)
        nev = 0
        # the JAX while_loop, with its `done` test read on the host
        for _ in range(opts.max_line_iters):
            merit = trial(alpha)
            nev += 1
            better = (best_a < 0.0) | (merit < best_m)
            best_a = torch.where(better, alpha, best_a)
            best_m = torch.where(better, merit, best_m)
            armijo_ok = (merit - opts.armijo_constant * alpha * dm0
                         < m0 + fprec)
            # quadratic interpolation backtrack
            denom = merit - m0 - dm0 * alpha
            if opts.use_backtracking_alpha:
                alpha_new = 0.5 * alpha
            else:
                alpha_new = torch.where(
                    denom != 0.0,
                    -0.5 * dm0 * alpha * alpha
                    / torch.where(denom != 0.0, denom, 1.0), alpha_min)
                alpha_new = _clip(alpha_new, 0.01 * alpha, alpha)
            alpha_next = torch.maximum(alpha_new, alpha_min)
            done = armijo_ok | (alpha <= alpha_min)
            success = success | armijo_ok
            alpha = torch.where(done, alpha, alpha_next)
            if host(done):
                break
        # Armijo failed everywhere: fall back to the best alpha seen when
        # it does not increase the merit beyond precision
        use_best = (~success) & (best_m <= m0 + fprec) & (best_a > 0.0)
        alpha = torch.where(success, alpha,
                            torch.where(use_best, best_a, 0.0))
        # descent-direction failure: don't move
        alpha = torch.where(dm0 >= 0.0, 0.0, alpha)
        no_improve = (((best_m >= m0 - fprec) & (best_m <= m0 + fprec))
                      | (alpha <= 0.0) | (px_norm < dprec))
        neval_add = zero_i + nev
    else:
        alpha = one
        m1 = trial(alpha)
        no_improve = (((m1 >= m0 - fprec) & (m1 <= m0 + fprec))
                      | (torch.abs(dm0) <= fprec))
        neval_add = zero_i + 1

    # -- apply the step -----------------------------------------------------
    vn = v.axpy(alpha, alpha, ps)
    vn = IPVars(x=clip_x(vn.x),
                zl=torch.where(d.lb_mask > 0, floor(vn.zl), 0.0),
                zu=torch.where(d.ub_mask > 0, floor(vn.zu), 0.0),
                s=floor(vn.s), t=floor(vn.t), z=vn.z, zs=floor(vn.zs),
                zt=floor(vn.zt), sw=floor(vn.sw), tw=floor(vn.tw), zw=vn.zw,
                zsw=floor(vn.zsw), ztw=floor(vn.ztw))

    with record_function("paropt.eval"):
        fobj_n, c_n, cw_n = model.eval_obj_con(model_params, vn.x)
        g_n, A_n = model.eval_grad(model_params, vn.x)

    # optional in-loop quasi-Newton update
    qn_n = state.qn
    if opts.use_quasi_newton_update and state.qn is not None:
        y = g_n - A_n.T @ vn.z if d.ncon else g_n
        y0 = state.g - state.A.T @ vn.z if d.ncon else state.g
        if d.nwcon > 0:
            y = y - d.Aw_rmatvec(vn.zw)
            y0 = y0 - d.Aw_rmatvec(vn.zw)
        with record_function("paropt.qn_update"):
            qn_n, _, _ = qnmod.qn_update(
                state.qn, alpha * ps.x, y - y0,
                compact=None if opts.use_diag_hessian else cq,
                accept=alpha > 0.0)

    ls_count = torch.where(no_improve, ls_base + 1, zero_i)

    new_state = FusedState(
        vars=vn, qn=qn_n, mu=mu, rho=rho, fobj=fobj_n, c=c_n, cw=cw_n,
        g=g_n, A=A_n, k=state.k + 1, converged=converged,
        res_norm=res_norm, comp=comp, fobj_prev=state.fobj,
        line_search_test=ls_count, neval=state.neval + neval_add + 1,
        alpha=alpha, alpha_x=ax, alpha_z=az, gmres_iters=zero_i)

    # fail-stop: a non-finite accepted state freezes at the previous one
    bad = ~(torch.isfinite(fobj_n) & torch.isfinite(torch.max(torch.abs(vn.x)))
            & torch.isfinite(torch.max(torch.abs(g_n))))
    stop = converged | bad

    # freeze every field (the QN state included) once stopped, recording
    # the converging iteration's res_norm/mu
    old = dataclasses.replace(state, converged=stop, res_norm=res_norm, mu=mu)
    return tmap(lambda new, prev: torch.where(stop, prev, new),
                new_state, old)


# ---------------------------------------------------------------------------
# convenience: wrap a Problem for the fused solver
# ---------------------------------------------------------------------------


def model_from_problem(problem) -> ModelFns:
    """ModelFns closing over a `Problem` (model_params unused: pass ())."""

    def ev(params, x):
        f, c = problem.eval_obj_con(x)
        cw = (problem.eval_sparse_con(x) if problem.nwcon > 0
              else x.new_zeros(0))
        return f, c, cw

    def gr(params, x):
        return problem.eval_obj_con_gradient(x)

    def hd(params, x, z, zw):
        return problem.eval_hessian_diag(x, z, zw)

    def hvp(params, x, z, zw, px):
        return problem.eval_hvec_product(x, z, zw, px)

    return ModelFns(eval_obj_con=ev, eval_grad=gr, hess_diag=hd, hvp=hvp)


def data_template_from_problem(problem, penalty_gamma: float = 1000.0,
                               max_bound_value: float = 1e20,
                               dtype=None) -> tuple[ProblemData, Any]:
    """The ProblemData template (bounds, masks, penalties, sparse-Jacobian
    pattern) + x0 for a `Problem`, on the device of its x0."""
    dtype = resolve_dtype(dtype)
    x0, lb, ub = problem.get_vars_and_bounds()
    dev = x0.device
    kw = dict(dtype=dtype, device=dev)
    x0, lb, ub = x0.to(dtype), lb.to(dtype), ub.to(dtype)
    n, ncon, nwcon = problem.nvars, problem.ncon, problem.nwcon
    if nwcon > 0:
        Aw = problem.sparse_jacobian(x0)
        cols, vals = Aw.cols, Aw.vals.to(dtype)
        layout = kkt.detect_aw_layout(cols.cpu().numpy(), n)
    else:
        cols = vals = None
        layout = "gather"
    d = ProblemData(
        g=torch.zeros(n, **kw), A=torch.zeros((ncon, n), **kw),
        c=torch.zeros(ncon, **kw), cw=torch.zeros(nwcon, **kw),
        lb=lb, ub=ub,
        lb_mask=(lb > -max_bound_value).to(dtype),
        ub_mask=(ub < max_bound_value).to(dtype),
        gamma_s=torch.as_tensor(np.where(np.arange(ncon) < problem.ninequality,
                                         0.0, penalty_gamma), **kw),
        gamma_t=torch.full((ncon,), penalty_gamma, **kw),
        gamma_sw=torch.as_tensor(
            np.where(np.arange(nwcon) < problem.nwinequality, 0.0,
                     penalty_gamma), **kw),
        gamma_tw=torch.full((nwcon,), penalty_gamma, **kw),
        Aw_cols=cols, Aw_vals=vals, nwblock=problem.nwblock,
        Aw_layout=layout)
    return d, x0
