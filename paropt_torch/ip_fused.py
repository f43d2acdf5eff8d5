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
the ρ update, the in-loop QN update, the Newton-Krylov phase
(``use_hvec_product``: `_fused_gmres`, unrolled to the subspace size; the
switch to it is read on the host once per step where JAX's ``lax.cond``
runs one branch), the non-finite fail-stop, the freeze once converged and
the facade's whole solve (`fused_ip_optimize`), k solves run as one
(`FusedIP.solve_batched`: the step's phases under ``torch.func.vmap``) and
the chunked solve (``jit_loop`` / ``chunk``, `utils.chunked.run_chunked`):
nothing is compiled, so ``jit_loop`` keeps JAX's stop rule and hook
boundaries over the same eager steps, and a chunked solve ends on the
unchunked one bit for bit.

Under torch.profiler the initial state, each solve loop, step and phase
is a span (`utils.spans`): ``paropt.ip.init``, then ``paropt.ip.solve``
holding the ``paropt.ip.step`` spans, each step its ``paropt.ip.head``
(the factor), the step solve, ``paropt.ip.merit``, its line-search trials
and ``paropt.ip.tail`` (the evaluation and the QN update); every host read
is a ``paropt.host_read``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from .dtypes import resolve_dtype
from .ip import (HostSyncs, _apply_step, _bmult, _bound_pads, _merit_eval,
                 _merit_parts, _nk_projections, _scale_step, _trial_point)
from .ops import kkt
from .ops import qn as qnmod
from .ops.kkt import IPVars, ProblemData
from .ops.veclib import dot, multi_norm
from .parallel.sharding import spmd
from .tree import bvmap, pytree, tmap
from .utils.chunked import host_reader, run_chunked, step_until
from .utils.spans import span, spanned

__all__ = ["FusedIP", "FusedIPOptions", "FusedState", "ModelFns",
           "HostSyncs", "model_from_problem", "data_template_from_problem",
           "fused_ip_optimize"]


@dataclasses.dataclass(frozen=True)
class ModelFns:
    """Pure-function problem definition; each callable takes
    (model_params, ...)."""
    eval_obj_con: Callable   # (params, x) -> (f, c[ncon], cw[nwcon])
    eval_grad: Callable      # (params, x) -> (g[n], A[ncon, n])
    hess_diag: Optional[Callable] = None  # (params, x, z, zw) -> h[n]
    hvp: Optional[Callable] = None        # (params, x, z, zw, px) -> H px


class FusedIPOptions(NamedTuple):
    """Solver options: the JAX package's fields and defaults."""
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
    # the Newton-Krylov (inexact GMRES) phase: once the residuals drop
    # below nk_switch_tol, solve the exact KKT linearization (autodiff
    # Hessian-vector products) by right-preconditioned GMRES, unrolled
    # inside the step
    use_hvec_product: bool = False
    gmres_subspace_size: int = 25
    nk_switch_tol: float = 1e-3
    eisenstat_walker_gamma: float = 1.0
    eisenstat_walker_alpha: float = 1.5
    max_gmres_rtol: float = 0.1
    gmres_atol: float = 1e-30


@pytree
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
    gmres_iters: torch.Tensor       # int32 GMRES arms run (0 = QN step)


def _norm_components(r: IPVars, norm_type: str):
    """(prime, dual, infeas) residual norms: the three groups the
    Newton-Krylov switch tests (`ParOptInteriorPoint.cpp:4853-4899`)."""
    prime = multi_norm([r.x, r.s, r.t], norm_type)
    dual = multi_norm([r.zl, r.zu, r.zs, r.zt, r.sw, r.tw, r.zsw, r.ztw],
                      norm_type)
    infeas = multi_norm([r.z, r.zw], norm_type)
    return prime, dual, infeas


def _norms(r: IPVars, norm_type: str):
    prime, dual, infeas = _norm_components(r, norm_type)
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
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.model = model
        self.n, self.ncon, self.nwcon = n, ncon, nwcon
        self.nwblock = nwblock
        self.opts = opts
        self.dtype = resolve_dtype(dtype)
        self.syncs = HostSyncs()

    @spmd
    def init(self, x0, data: ProblemData, model_params,
             qn_state: Optional[qnmod.QNState], compact) -> FusedState:
        """Initialize state (bounds clipping, multiplier start strategy)."""
        return _fused_init(self.model, self.opts, x0, data, model_params,
                           qn_state, compact)

    @spmd
    def step(self, state: FusedState, data: ProblemData, model_params,
             compact) -> FusedState:
        return _fused_step(self.model, self.opts, state, data, model_params,
                           compact, host=self.syncs)

    @spmd
    def solve(self, x0, data: ProblemData, model_params,
              qn_state: Optional[qnmod.QNState] = None, compact=None,
              jit_loop: bool = False, max_iters: Optional[int] = None,
              on_chunk=None, chunk=None,
              state0: Optional[FusedState] = None) -> FusedState:
        """Run to convergence or ``max_iters`` (default
        ``opts.max_major_iters``), as paropt_tpu/ip_fused.py:204-240.

        ``jit_loop=False`` (JAX's default): a host loop over steps that
        reads ``converged`` after each one and calls ``on_chunk(state)``
        after every step; from ``state0`` it runs ``max_iters`` more steps.
        ``jit_loop=True``: the loop stops at the absolute count
        ``max_iters``; with neither ``on_chunk`` nor ``chunk`` it is one
        call, otherwise `utils.chunked.run_chunked` runs it in windows of
        ``chunk`` (default ``'auto'``) and calls ``on_chunk`` at each
        boundary (build it with `utils.chunked.make_write_output_hook`).
        Nothing is compiled: every form runs the same eager steps, so the
        final state is the same under any chunk.  (JAX's one-call form
        runs to ``opts.max_major_iters`` whatever ``max_iters`` says; the
        port's stops at ``max_iters``.)  ``state0`` (a previous state, e.g.
        one restored from a checkpoint) resumes the solve from it in place
        of ``x0``'s initial state."""
        state = (state0 if state0 is not None
                 else self.init(x0, data, model_params, qn_state, compact))
        iters = max_iters or self.opts.max_major_iters
        if not jit_loop:
            return _fused_solve_loop(self.model, self.opts, state, data,
                                     model_params, compact, self.syncs,
                                     max_iters=iters, on_step=on_chunk)
        window = chunk if chunk is not None else (
            None if on_chunk is None else "auto")

        def run(s, k, k_stop):
            return _fused_solve_loop(self.model, self.opts, s, data,
                                     model_params, compact, self.syncs,
                                     max_iters=k_stop - k)

        return run_chunked(run, state, iters, window, on_chunk=on_chunk,
                           read=host_reader(self.syncs))

    def solve_batched(self, x0_batch, data: ProblemData, model_params=(),
                      qn_state: Optional[qnmod.QNState] = None, compact=None,
                      data_axes=None, model_params_axes=None,
                      max_iters: Optional[int] = None) -> FusedState:
        """Run k whole solves as one: multi-start, or a sweep over problem
        data (paropt_tpu/ip_fused.py:241-289, JAX's ``vmap`` of its
        ``while_loop``).

        Every phase of a step runs once for all instances under
        ``torch.func.vmap``, so each kernel launches once per call with its
        instance axis; the host reads one flag per loop turn (every
        instance converged; every line search done; some instance asking
        for NK).  An instance that has converged keeps its state bit for
        bit while the others iterate.

        ``x0_batch``: [k, n] starting points.  ``data`` and
        ``model_params`` are shared unless ``data_axes`` /
        ``model_params_axes`` give, as in JAX, a prefix tree of 0 or None
        (e.g. ``dataclasses.replace(tmap(lambda _: None, data), ub=0)``
        with ``data.ub`` of shape [k, n]).  ``qn_state`` and ``compact``
        are shared.  Returns a `FusedState` whose every leaf has a leading
        k axis (`tree.take(state, i)` is instance i)."""
        run = _Run(self.syncs, batched=True)
        x0_batch = torch.as_tensor(x0_batch, device=data.lb.device)
        state = run.call(functools.partial(_fused_init, self.model,
                                           self.opts),
                         (0, data_axes, model_params_axes, None, None),
                         x0_batch, data, model_params, qn_state, compact)
        return _fused_solve_loop(self.model, self.opts, state, data,
                                 model_params, compact, self.syncs,
                                 max_iters=max_iters, run=run,
                                 axes=(data_axes, model_params_axes, None))


# ---------------------------------------------------------------------------
# implementation
# ---------------------------------------------------------------------------


def _refresh_data(d: ProblemData, g, A, c, cw) -> ProblemData:
    return dataclasses.replace(d, g=g, A=A, c=c, cw=cw)


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
    return (torch.full((), b0, dtype=state.vars.x.dtype,
                       device=state.vars.x.device), None, None)


@spanned("paropt.ip.init")
def _fused_init(model: ModelFns, opts: FusedIPOptions, x0, d: ProblemData,
                model_params, qn_state, compact) -> FusedState:
    dtype = x0.dtype
    dev = x0.device
    # a fill on the device: torch.tensor(val, device=...) copies from the
    # host, which waits for the device on a card
    scalar = lambda val: torch.full((), val, dtype=dtype, device=dev)
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


def _fused_gmres(model: ModelFns, opts: FusedIPOptions, model_params,
                 v: IPVars, d: ProblemData, f, cq, r: IPVars, rtol, mu):
    """Right-preconditioned GMRES on the exact KKT linearization, unrolled
    to ``gmres_subspace_size`` arms (paropt_tpu/ip_fused.py:442-615).

    - operator: the Lagrangian Hessian-vector product ``model.hvp``;
    - preconditioner: the KKT factor ``f`` (one `solve_kkt` per Krylov
      vector);
    - every arm runs: once converged, masks freeze the recurrence so the
      later arms are inert, and nothing is read on the host;
    - each Krylov vector is kept as an x-vector w and one scalar a (the
      full vector N·w + (a/‖b‖)·(I-NNᵀ)·b); the step is recovered with one
      more `solve_kkt` of the subspace combination, negated so that it
      solves K p = -r like the quasi-Newton step;
    - the assembled step must be a descent direction, else the
      quasi-Newton step ``solve_kkt(r)`` is returned.

    Returns (step, arms run); the arms are reported even when the step is
    rejected, as in JAX."""

    def tdot(a, c):
        return sum(dot(getattr(a, fl.name), getattr(c, fl.name))
                   for fl in dataclasses.fields(a))

    def precon(w):
        return kkt.solve_kkt(v, d, f, w, qn_compact=cq)

    msub = opts.gmres_subspace_size
    b = r  # solve_kkt solves K p = -b; GMRES runs on A = -K·K_B⁻¹
    bsq = tdot(b, b)
    bnorm = torch.sqrt(bsq)
    bsafe = torch.clamp(bnorm, min=1e-300)
    atol = opts.gmres_atol
    # β: the non-x energy of b, normalized
    beta_n = (bsq - dot(b.x, b.x)) / (bsafe * bsafe)

    def embed(wx, a):
        scale = a / bsafe
        return dataclasses.replace(tmap(lambda leaf: scale * leaf, b), x=wx)

    # descent-gate threshold (`ParOptInteriorPoint.cpp:6154-6189`), applied
    # to the assembled step after the loop
    zero = torch.zeros((), dtype=v.x.dtype, device=v.x.device)
    cinfeas = torch.linalg.norm(d.c - v.s + v.t) if d.ncon else zero
    cwinfeas = torch.linalg.norm(d.cw - v.sw + v.tw) if d.nwcon else zero
    descent_thresh = -0.01 * (cinfeas + cwinfeas)

    W = [b.x / bsafe]                     # x-components of the basis
    al = [zero + 1.0]                     # non-x scalars
    H = [[zero for _ in range(msub)] for _ in range(msub + 1)]
    cs = [zero for _ in range(msub)]
    sn = [zero for _ in range(msub)]
    g_vec = [zero for _ in range(msub + 1)]
    g_vec[0] = bnorm
    done = torch.zeros((), dtype=torch.bool, device=v.x.device)
    last_res = bnorm
    iters = torch.zeros((), dtype=torch.int32, device=v.x.device)

    for j in range(msub):
        was_done = done
        # z_j = -K_B⁻¹ v̂_j (transient); A v̂_j = K z_j = -v̂_j + N(H-B)z_j.x
        zj = precon(embed(W[j], al[j]))
        hv = model.hvp(model_params, v.x, v.z, v.zw, zj.x)
        w = -W[j] + (hv - _bmult(cq, zj.x))
        a = -al[j]
        for i in range(j + 1):
            hij = dot(w, W[i]) + beta_n * a * al[i]
            H[i][j] = torch.where(was_done, zero, hij)
            w = w - H[i][j] * W[i]
            a = a - H[i][j] * al[i]
        wnorm = torch.sqrt(torch.clamp(dot(w, w) + beta_n * a * a, min=0.0))
        wsafe = torch.clamp(wnorm, min=1e-300)
        hsub = torch.where(was_done, zero, wnorm)
        W.append(w / wsafe)
        al.append(a / wsafe)
        # Givens rotations maintaining the QR of H
        for i in range(j):
            t = cs[i] * H[i][j] + sn[i] * H[i + 1][j]
            H[i + 1][j] = -sn[i] * H[i][j] + cs[i] * H[i + 1][j]
            H[i][j] = t
        denom = torch.sqrt(H[j][j] ** 2 + hsub ** 2)
        dsafe = torch.clamp(denom, min=1e-300)
        cs[j] = torch.where(denom > 0.0, H[j][j] / dsafe, zero + 1.0)
        sn[j] = torch.where(denom > 0.0, hsub / dsafe, zero)
        # frozen arms keep H[j][j] = 1 so back-substitution gives y = 0
        H[j][j] = torch.where(was_done, zero + 1.0, denom)
        g_next = -sn[j] * g_vec[j]
        g_vec[j] = torch.where(was_done, g_vec[j], cs[j] * g_vec[j])
        g_vec[j + 1] = torch.where(was_done, zero, g_next)
        res = torch.abs(g_vec[j + 1])
        last_res = torch.where(was_done, last_res, res)
        iters = iters + (~was_done).to(torch.int32)
        done = done | (res < rtol * bnorm) | (res < atol) | (wnorm <= 0.0)

    # back-substitute y over the whole (masked) subspace
    y = [zero for _ in range(msub)]
    for i in range(msub - 1, -1, -1):
        acc = g_vec[i]
        for t in range(i + 1, msub):
            acc = acc - H[i][t] * y[t]
        y[i] = acc / torch.where(H[i][i] != 0.0, H[i][i], zero + 1.0)
    # the subspace combination u = Σ yᵢ v̂ᵢ in (w, a) form
    u_w = y[0] * W[0]
    u_a = y[0] * al[0]
    for i in range(1, msub):
        u_w = u_w + y[i] * W[i]
        u_a = u_a + y[i] * al[i]

    final_res = last_res
    ok = (torch.isfinite(final_res) & (final_res <= bnorm) & (iters > 0)
          & torch.isfinite(dot(u_w, u_w) + beta_n * u_a * u_a))
    # precon solves K z = -w, so K (Σ yᵢ zᵢ) = +r: negate the combination
    # before the final preconditioner application (JAX's sign fix)
    p_nk = precon(embed(torch.where(ok, -u_w, b.x),
                        torch.where(ok, -u_a, bsafe)))
    # the assembled step must be a descent direction; the fused b is the
    # unnegated residual, so cproj flips sign
    fpr, cpr_neg = _nk_projections(v, d, b, p_nk, mu, opts.rel_bound_barrier)
    accept = ok & ((fpr < 0.0) | (-cpr_neg < descent_thresh))
    p_qn = precon(b)
    p_out = tmap(lambda a2, b2: torch.where(accept, a2, b2), p_nk, p_qn)
    return p_out, iters


def _clip(x, lo, hi):
    """jnp.clip with tensor bounds: min(max(x, lo), hi)."""
    return torch.minimum(torch.maximum(x, lo), hi)


def _neg_or(x, fill=-1.0):
    """x where x < 0, else ``fill`` (a safe denominator)."""
    return torch.where(x < 0.0, x, fill)


class _Run:
    """How the phases of a step run, and how the host reads a flag.

    One instance: each phase is a plain call and a flag is read as it is.
    ``batched``: each phase runs under ``torch.func.vmap`` over the leading
    instance axis (`tree.bvmap`, with JAX's ``in_axes`` meaning), a loop's
    flag is read as "every instance" (`all`) or "some instance" (`any`),
    and `freeze` keeps the carry of the instances that were already done,
    bit for bit, as JAX's ``while_loop`` batching rule does.  Either way a
    read is one host sync, counted by ``host``."""

    def __init__(self, host, batched: bool = False):
        self.host = host
        self.batched = batched

    def call(self, fn, axes, *args):
        return bvmap(fn, axes, *args) if self.batched else fn(*args)

    def all(self, flag) -> bool:
        return self.host(torch.all(flag) if self.batched else flag)

    def any(self, flag) -> bool:
        return self.host(torch.any(flag) if self.batched else flag)

    def freeze(self, done, new, old):
        """``old`` where ``done`` (the incoming flag), else ``new``."""
        if not self.batched:
            return new
        return bvmap(_keep, (0, 0, 0), done, new, old)


def _keep(done, new, old):
    return tmap(lambda a, b: torch.where(done, b, a), new, old)


class _Head(NamedTuple):
    """What a step computes before its step solve."""
    f: kkt.KKTFactor
    cq: Any                  # the Hessian's compact form
    r: IPVars                # the residual at the new μ (corrector incl.)
    mu: torch.Tensor
    res_norm: torch.Tensor
    converged: torch.Tensor
    ls_base: torch.Tensor
    comp: torch.Tensor
    use_nk: torch.Tensor     # the Newton-Krylov switch (False when off)
    ew_rtol: Optional[torch.Tensor]


class _Merit(NamedTuple):
    """The scaled step and the merit function's pieces at α = 0."""
    ps: IPVars
    ax: torch.Tensor
    az: torch.Tensor
    rho: torch.Tensor
    m0: torch.Tensor
    dm0: torch.Tensor
    px_norm: Optional[torch.Tensor]     # the line search's pieces
    alpha_min: Optional[torch.Tensor]


class _LineSearch(NamedTuple):
    """The line search's carry (the JAX while_loop's)."""
    alpha: torch.Tensor
    best_a: torch.Tensor
    best_m: torch.Tensor
    done: torch.Tensor
    success: torch.Tensor
    nev: torch.Tensor       # int32 trials run


def _nk_enabled(opts: FusedIPOptions, model: ModelFns) -> bool:
    return (opts.use_hvec_product and opts.gmres_subspace_size > 0
            and model.hvp is not None)


@spanned("paropt.ip.head")
def _step_head(model: ModelFns, opts: FusedIPOptions, state: FusedState,
               d: ProblemData, model_params, compact) -> _Head:
    """The step up to its solve: the factor, the barrier update, the
    residual and its norm, the convergence test, the NK switch."""
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
    # spans label the phases in torch.profiler traces (the counterpart of
    # the JAX step's named scopes)
    with span("paropt.kkt_factor"):
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

    use_nk = torch.zeros((), dtype=torch.bool, device=dev)
    ew_rtol = None
    if _nk_enabled(opts, model):
        # Newton-Krylov switch (`ParOptInteriorPoint.cpp:4853-4899`):
        # residual groups small and the Eisenstat-Walker forcing term small
        prime0, dual0, infeas0 = _norm_components(r, opts.norm_type)
        ew_rtol = (opts.eisenstat_walker_gamma
                   * (res_norm / torch.clamp(state.res_norm, min=1e-300))
                   ** opts.eisenstat_walker_alpha)
        nk_tol = opts.nk_switch_tol
        use_nk = ((state.k > 0) & (prime0 < nk_tol) & (dual0 < nk_tol)
                  & (infeas0 < nk_tol) & (ew_rtol < opts.max_gmres_rtol))
    return _Head(f=f, cq=cq, r=r, mu=mu, res_norm=res_norm,
                 converged=converged, ls_base=ls_base, comp=comp,
                 use_nk=use_nk, ew_rtol=ew_rtol)


def _step_qn(opts: FusedIPOptions, state: FusedState, d: ProblemData,
             head: _Head):
    """The step solve with the factor: (step, 0 GMRES arms)."""
    d = _refresh_data(d, state.g, state.A, state.c, state.cw)
    with span("paropt.kkt_solve"):
        p = kkt.solve_kkt(state.vars, d, head.f, head.r,
                          refine_steps=opts.iterative_refinement_steps,
                          qn_compact=head.cq)
    return p, torch.zeros((), dtype=torch.int32, device=p.x.device)


def _step_nk(model: ModelFns, opts: FusedIPOptions, state: FusedState,
             d: ProblemData, model_params, head: _Head):
    """The Newton-Krylov step solve: (step, GMRES arms)."""
    d = _refresh_data(d, state.g, state.A, state.c, state.cw)
    with span("paropt.kkt_solve_nk"):
        return _fused_gmres(
            model, opts, model_params, state.vars, d, head.f, head.cq,
            head.r, torch.clamp(head.ew_rtol, 1e-12, opts.max_gmres_rtol),
            head.mu)


def _pick_nk(use_nk, p_nk, it_nk, p_qn, it_qn):
    """Per instance, the NK step where it was asked for, else the QN step
    (the select ``lax.cond`` becomes under ``vmap``)."""
    return (tmap(lambda a, b: torch.where(use_nk, a, b), p_nk, p_qn),
            torch.where(use_nk, it_nk, it_qn))


@spanned("paropt.ip.merit")
def _step_merit(opts: FusedIPOptions, state: FusedState, d: ProblemData,
                head: _Head, p: IPVars) -> _Merit:
    """Fraction-to-boundary scaling, the merit pieces and the ρ update."""
    v = state.vars
    d = _refresh_data(d, state.g, state.A, state.c, state.cw)
    tol = opts.abs_res_tol
    mu = head.mu
    ps, ax, az, _ = _scale_step(v, d, p, mu, head.comp,
                                opts.min_fraction_to_boundary)
    merit0, pmerit0, infeas, infeas_proj, pTBp = _merit_parts(
        v, d, ps, state.fobj, mu, opts.rel_bound_barrier, head.cq, True)

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
    px_norm = alpha_min = None
    if opts.use_line_search:
        px_norm = torch.max(torch.abs(ps.x))
        alpha_min = torch.clamp(
            torch.where(px_norm > 0,
                        opts.function_precision
                        / torch.clamp(px_norm, min=1e-300), 1.0),
            max=0.5)
    return _Merit(ps=ps, ax=ax, az=az, rho=rho, m0=m0, dm0=dm0,
                  px_norm=px_norm, alpha_min=alpha_min)


@spanned("paropt.line_search_trial")
def _trial_merit(model: ModelFns, opts: FusedIPOptions, state: FusedState,
                 d: ProblemData, model_params, head: _Head, mer: _Merit,
                 alpha):
    """The merit function at the trial point v + α·ps."""
    xt, st, tt, swt, twt = _trial_point(state.vars, d, mer.ps, alpha,
                                        opts.design_precision)
    ft, ct, cwt = model.eval_obj_con(model_params, xt)
    return _merit_eval(xt, st, tt, swt, twt, ft, ct, cwt, d, head.mu,
                       opts.rel_bound_barrier, mer.rho)


def _ls_start(state: FusedState, done) -> _LineSearch:
    """The line search's initial carry; ``done`` marks the instances that
    run no trial (those already stopped, in a batch)."""
    x = state.vars.x
    one = torch.ones((), dtype=x.dtype, device=x.device)
    return _LineSearch(alpha=one, best_a=-one, best_m=0.0 * one, done=done,
                       success=torch.zeros_like(done),
                       nev=torch.zeros_like(state.k))


def _ls_trial(model: ModelFns, opts: FusedIPOptions, state: FusedState,
              d: ProblemData, model_params, head: _Head, mer: _Merit,
              ls: _LineSearch) -> _LineSearch:
    """One trial of the merit line search (the JAX while_loop's body).  A
    carry that is already done is kept as it is, as JAX's batching rule
    keeps it; one instance runs a trial only while it is not done."""
    d = _refresh_data(d, state.g, state.A, state.c, state.cw)
    fprec = opts.function_precision
    alpha, m0, dm0 = ls.alpha, mer.m0, mer.dm0
    merit = _trial_merit(model, opts, state, d, model_params, head, mer,
                         alpha)
    better = (ls.best_a < 0.0) | (merit < ls.best_m)
    best_a = torch.where(better, alpha, ls.best_a)
    best_m = torch.where(better, merit, ls.best_m)
    armijo_ok = merit - opts.armijo_constant * alpha * dm0 < m0 + fprec
    # quadratic interpolation backtrack
    denom = merit - m0 - dm0 * alpha
    if opts.use_backtracking_alpha:
        alpha_new = 0.5 * alpha
    else:
        alpha_new = torch.where(
            denom != 0.0,
            -0.5 * dm0 * alpha * alpha
            / torch.where(denom != 0.0, denom, 1.0), mer.alpha_min)
        alpha_new = _clip(alpha_new, 0.01 * alpha, alpha)
    alpha_next = torch.maximum(alpha_new, mer.alpha_min)
    done = armijo_ok | (alpha <= mer.alpha_min)
    keep = ls.done
    return _LineSearch(
        alpha=torch.where(keep | done, alpha, alpha_next),
        best_a=torch.where(keep, ls.best_a, best_a),
        best_m=torch.where(keep, ls.best_m, best_m),
        done=keep | done,
        success=ls.success | (~keep & armijo_ok),
        nev=ls.nev + (~keep).to(ls.nev.dtype))


@spanned("paropt.ip.tail")
def _step_tail(model: ModelFns, opts: FusedIPOptions, state: FusedState,
               d: ProblemData, model_params, compact, head: _Head,
               mer: _Merit, ls: Optional[_LineSearch],
               nk_iters) -> FusedState:
    """The step after its line search: the accepted α, the new point and
    its evaluation, the QN update, the fail-stop and the freeze."""
    v = state.vars
    d = _refresh_data(d, state.g, state.A, state.c, state.cw)
    fprec = opts.function_precision
    dprec = opts.design_precision
    m0, dm0 = mer.m0, mer.dm0
    if ls is not None:
        # Armijo failed everywhere: fall back to the best alpha seen when
        # it does not increase the merit beyond precision
        use_best = (~ls.success) & (ls.best_m <= m0 + fprec) & (ls.best_a > 0.0)
        alpha = torch.where(ls.success, ls.alpha,
                            torch.where(use_best, ls.best_a, 0.0))
        # descent-direction failure: don't move
        alpha = torch.where(dm0 >= 0.0, 0.0, alpha)
        no_improve = (((ls.best_m >= m0 - fprec) & (ls.best_m <= m0 + fprec))
                      | (alpha <= 0.0) | (mer.px_norm < dprec))
        neval_add = ls.nev
    else:
        alpha = torch.ones((), dtype=v.x.dtype, device=v.x.device)
        m1 = _trial_merit(model, opts, state, d, model_params, head, mer,
                          alpha)
        no_improve = (((m1 >= m0 - fprec) & (m1 <= m0 + fprec))
                      | (torch.abs(dm0) <= fprec))
        neval_add = torch.ones_like(state.k)
    ps = mer.ps

    # -- apply the step -----------------------------------------------------
    vn = _apply_step(v, d, ps, alpha, dprec)

    with span("paropt.eval"):
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
        with span("paropt.qn_update"):
            qn_n, _, _ = qnmod.qn_update(
                state.qn, alpha * ps.x, y - y0,
                compact=None if opts.use_diag_hessian else head.cq,
                accept=alpha > 0.0)

    ls_count = torch.where(no_improve, head.ls_base + 1,
                           torch.zeros_like(state.k))
    converged, res_norm, mu = head.converged, head.res_norm, head.mu

    new_state = FusedState(
        vars=vn, qn=qn_n, mu=mu, rho=mer.rho, fobj=fobj_n, c=c_n, cw=cw_n,
        g=g_n, A=A_n, k=state.k + 1, converged=converged,
        res_norm=res_norm, comp=head.comp, fobj_prev=state.fobj,
        line_search_test=ls_count, neval=state.neval + neval_add + 1,
        alpha=alpha, alpha_x=mer.ax, alpha_z=mer.az, gmres_iters=nk_iters)

    # fail-stop: a non-finite accepted state freezes at the previous one
    bad = ~(torch.isfinite(fobj_n) & torch.isfinite(torch.max(torch.abs(vn.x)))
            & torch.isfinite(torch.max(torch.abs(g_n))))
    stop = converged | bad

    # freeze every field (the QN state included) once stopped, recording
    # the converging iteration's res_norm/mu
    old = dataclasses.replace(state, converged=stop, res_norm=res_norm, mu=mu)
    return tmap(lambda new, prev: torch.where(stop, prev, new),
                new_state, old)


@spanned("paropt.ip.step")
def _fused_step(model: ModelFns, opts: FusedIPOptions, state: FusedState,
                d: ProblemData, model_params, compact,
                host: Callable[[torch.Tensor], bool] = bool,
                run: Optional[_Run] = None,
                axes=(None, None, None)) -> FusedState:
    """One full major iteration, as its phases (`_step_head`, the step
    solve, `_step_merit`, `_ls_trial` per line-search trial, `_step_tail`)
    with the host reads between them: the NK switch and the line search's
    ``done``, read by ``host``.  ``run`` (a batched `_Run`) runs the phases
    over k instances; ``axes`` are then the instance axes of (d,
    model_params, compact)."""
    R = run or _Run(host)
    da, pa, ca = axes
    head = R.call(functools.partial(_step_head, model, opts), (0, da, pa, ca),
                  state, d, model_params, compact)

    # -- KKT step: JAX's lax.cond between the NK and QN solves is read on
    #    the host, once per step; in a batch, NK runs when some live
    #    instance asks for it and the others keep their QN step -----------
    qn_step = functools.partial(_step_qn, opts)
    want = head.use_nk & ~state.converged if R.batched else head.use_nk
    if _nk_enabled(opts, model) and R.any(want):
        p, nk_iters = R.call(functools.partial(_step_nk, model, opts),
                             (0, da, pa, 0), state, d, model_params, head)
        if R.batched:
            p_qn, it_qn = R.call(qn_step, (0, da, 0), state, d, head)
            p, nk_iters = R.call(_pick_nk, (0,) * 5, want, p, nk_iters,
                                 p_qn, it_qn)
    else:
        p, nk_iters = R.call(qn_step, (0, da, 0), state, d, head)

    mer = R.call(functools.partial(_step_merit, opts), (0, da, 0, 0),
                 state, d, head, p)

    # -- line search: the JAX while_loop, its `done` read on the host -------
    ls = None
    if opts.use_line_search:
        done0 = (state.converged if R.batched
                 else torch.zeros_like(state.converged))
        ls = R.call(_ls_start, (0, 0), state, done0)
        trial = functools.partial(_ls_trial, model, opts)
        for _ in range(opts.max_line_iters):
            ls = R.call(trial, (0, da, pa, 0, 0, 0), state, d, model_params,
                        head, mer, ls)
            if R.all(ls.done):
                break

    return R.call(functools.partial(_step_tail, model, opts),
                  (0, da, pa, ca, 0, 0, 0, 0), state, d, model_params,
                  compact, head, mer, ls, nk_iters)


def _fused_solve_loop(model: ModelFns, opts: FusedIPOptions,
                      state: FusedState, d: ProblemData, model_params,
                      compact, host: Callable[[torch.Tensor], bool],
                      max_iters: Optional[int] = None,
                      on_step=None, run: Optional[_Run] = None,
                      axes=(None, None, None)) -> FusedState:
    """Step until ``converged`` (read on the host after each step) or
    ``max_iters`` (default ``opts.max_major_iters``): the counterpart of
    JAX's ``lax.while_loop`` solve.  With a batched ``run`` the loop steps
    until every instance is converged, and an instance that is converged
    keeps its state bit for bit while the others step."""
    R = run or _Run(host)

    def step(s):
        new = _fused_step(model, opts, s, d, model_params, compact, run=R,
                          axes=axes)
        s = R.freeze(s.converged, new, s)
        if on_step is not None:
            on_step(s)
        return s

    n = opts.max_major_iters if max_iters is None else max_iters
    with span("paropt.ip.solve"):
        return step_until(step, lambda s: R.all(s.converged), state, 0, n)


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
                               dtype=None, mesh=None
                               ) -> tuple[ProblemData, Any]:
    """The ProblemData template (bounds, masks, penalties, sparse-Jacobian
    pattern) + x0 for a `Problem`, on the device of its x0; with ``mesh``
    (`parallel.sharding`) both placed on it by `shard_tree`'s rule."""
    if mesh is not None:
        from .parallel.sharding import shard_tree
        d, x0 = data_template_from_problem(problem, penalty_gamma,
                                           max_bound_value, dtype)
        return (shard_tree(d, mesh, problem.nvars),
                shard_tree(x0, mesh, problem.nvars))
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


def fused_ip_optimize(problem, options=None, state0=None):
    """Facade-style whole solve on the fused IP
    (`Optimizer(..., {"algorithm": "ip", "use_fused_loop": True})`).

    Maps the registry options onto `FusedIPOptions` (the mapping the TR/MMA
    inner solvers use, `tr._fused_ip_options`), builds the model, data and
    QN state on the problem's device, runs the solve, and returns (result
    dict shaped like `InteriorPoint.optimize`, final `FusedState`).  The
    ``ip_checkpoint_file`` option writes the full state at the
    ``write_output_frequency`` cadence, at the chunk boundaries of
    ``FusedIP.solve(jit_loop=True, chunk="auto")``, as JAX's
    (paropt_tpu/ip_fused.py:1082-1084); ``state0`` (such a state, restored
    with `utils.checkpoint.restore_state`) resumes from it and stops at the
    absolute count ``max_major_iters``."""
    from .ip import _resolve_qn_storage
    from .tr import _fused_ip_options
    from .utils.chunked import make_write_output_hook, user_write_output
    from .utils.options import make_options

    o = options if hasattr(options, "descriptors") else \
        make_options(options or {}, which="facade")
    dt = torch.float64 if o["dtype"] == "float64" else torch.float32
    fopts = _fused_ip_options(
        o, o["barrier_strategy"], o["starting_point_strategy"],
        o["sequential_linear_method"])._replace(
        use_quasi_newton_update=not o["sequential_linear_method"])

    model = model_from_problem(problem)
    data, x0 = data_template_from_problem(
        problem, penalty_gamma=o["penalty_gamma"],
        max_bound_value=o["max_bound_value"], dtype=dt)
    qn0 = None
    msub = qnmod.resolve_subspace_size(
        o["qn_subspace_size"], o["qn_subspace_auto"], problem.nvars, dt)
    if o["qn_type"] != "none" and not o["sequential_linear_method"] \
            and msub > 0:
        qn0 = qnmod.qn_init(
            msub, problem.nvars, dtype=dt, qn_type=o["qn_type"],
            storage_dtype=_resolve_qn_storage(o["qn_storage_dtype"], dt),
            update_type=o["qn_update_type"], diag_type=o["qn_diag_type"],
            device=x0.device)
    fused = FusedIP(model, problem.nvars, problem.ncon, problem.nwcon,
                    problem.nwblock, fopts, dtype=dt)
    # the writeOutput and checkpoint cadence of
    # `ParOptInteriorPoint.cpp:4620-4631`
    hook = make_write_output_hook(user_write_output(problem),
                                  o["write_output_frequency"],
                                  get_x=lambda st: st.vars.x,
                                  checkpoint_path=o["ip_checkpoint_file"],
                                  syncs=fused.syncs)
    state = fused.solve(x0, data, (), qn0, None, jit_loop=True,
                        on_chunk=hook, chunk="auto", state0=state0)
    converged = bool(state.converged)
    result = {
        "x": state.vars.x, "fobj": float(state.fobj),
        "converged": converged,
        "reason": "tolerance" if converged else "max iterations",
        "niter": int(state.k), "neval": int(state.neval),
        # one gradient evaluation per accepted major iteration + init
        "ngeval": int(state.k) + 1,
        "res_norm": float(state.res_norm), "mu": float(state.mu),
    }
    return result, state
