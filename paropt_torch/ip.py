"""Primal-dual interior-point optimizer, the host loop (counterpart of
paropt_tpu/ip.py, where the method is documented).

`InteriorPoint` runs the reference's major iteration on the host: the
barrier strategies (monotone, Mehrotra, Mehrotra predictor-corrector,
complementarity fraction), the least-squares and affine-step starts, the ρ
penalty update, the merit line search, the quasi-Newton update in
`_accept_step`, the DQN -> SLP -> LFail ladder, the step and gradient
verification hooks and the `IPLogger` rows.  The JAX package jits each
numerical phase (the ``_residual_and_norms`` ... ``_trial_point`` helpers
below); here they are plain eager functions of the state, and the host
decisions between them are JAX's.  Each decision reads device scalars on
the host; ``InteriorPoint.syncs`` counts those reads (several scalars read
together count once).

With ``use_hvec_product`` and a GMRES subspace, the Newton-Krylov phase
(`_gmres_step`) takes over once the residuals drop below ``nk_switch_tol``:
right-preconditioned GMRES on the exact KKT linearization, with the
problem's Hessian-vector products and the KKT factor as preconditioner.

Also here: the merit-function pieces the fused solvers share
(``_barrier_terms``, ``_infeas_l2``, ``_bound_pads``), the host-read counter
`HostSyncs` and the ``qn_storage_dtype`` mapping.

A `CSRSparseProblem` takes the general-CSR path: its Schur complement is
factored on the host by the native sparse Cholesky (`kkt.HostCSRFactor`),
which reads Dinv, C0 and every right-hand side from the device.  A problem
whose ``sparse_jacobian`` raises NotImplementedError takes the callback
path: its Jacobian products and block inner product come from the
problem's ``sparse_jacobian_vec`` / ``_tvec`` / ``sparse_inner_product``.
On both paths the Mehrotra predictor-corrector strategy takes JAX's eager
step (the plain step at the adapted μ), as the JAX package does there.

Checkpoints (``write_solution_file``, ``read_solution_file``,
``optimize(checkpoint=...)``) use the JAX package's npz format, the `IPVars`
fields and ``mu``, so a file that either package writes resumes in the
other.  A design vector sharded over a device mesh (a DTensor, placed by
`parallel.sharding`) runs the same loop, and its checkpoints are
``torch.distributed.checkpoint`` directories where the JAX package writes
Orbax ones.
"""

from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .dtypes import resolve_device
from .ops import kkt
from .ops import qn as qnmod
from .ops.kkt import IPVars, ProblemData
from .ops.veclib import dot, matmul, multi_norm, norm
from .parallel.sharding import (is_sharded, place_like, spmd,
                                tree_is_sharded)
from .tree import tmap
from .utils.logging import IPLogger
from .utils.options import OptionRegistry, make_options
from .utils.spans import HOST_READ, span

__all__ = ["InteriorPoint", "HostSyncs", "LS_SUCCESS", "LS_FAILURE",
           "LS_MIN_STEP", "LS_MAX_ITERS", "LS_NO_IMPROVEMENT",
           "LS_SHORT_STEP"]

# line search status flags (bitmask, mirroring the reference's enum)
LS_SUCCESS = 1
LS_FAILURE = 2
LS_MIN_STEP = 4
LS_MAX_ITERS = 8
LS_NO_IMPROVEMENT = 16
LS_SHORT_STEP = 32


class HostSyncs:
    """Reads device scalars on the host and counts the reads: each one
    waits for the device, and each runs inside a ``paropt.host_read`` span
    (`utils.spans`).  ``bytes_to_host`` and ``bytes_to_device`` add up
    the arrays moved by `array` and `upload`.

    A DTensor (sharded state) is read whole: a replicated one from its
    local copy, a sharded or partial one after ``full_tensor()``, whose
    gathered bytes ``bytes_gathered`` adds up."""

    def __init__(self):
        self.count = 0
        self.bytes_to_host = 0
        self.bytes_to_device = 0
        self.bytes_gathered = 0

    def _whole(self, t):
        if not is_sharded(t):
            return t
        from torch.distributed.tensor import Replicate
        if all(isinstance(p, Replicate) for p in t.placements):
            return t.to_local()
        self.bytes_gathered += t.numel() * t.element_size()
        return t.full_tensor()

    def __call__(self, flag: torch.Tensor) -> bool:
        self.count += 1
        with span(HOST_READ):
            return bool(self._whole(flag))

    def value(self, t) -> float:
        """One 0-d tensor as a Python float."""
        self.count += 1
        with span(HOST_READ):
            return float(self._whole(t))

    def values(self, *ts) -> list:
        """Several 0-d tensors as Python floats, read in one transfer (each
        widened to float64 first, which keeps its value exactly)."""
        self.count += 1
        with span(HOST_READ):
            return torch.stack([self._whole(t).to(torch.float64)
                                for t in ts]).tolist()

    def array(self, t) -> np.ndarray:
        """A tensor as a numpy array."""
        self.count += 1
        with span(HOST_READ):
            t = self._whole(t)
            if t.device.type != "cpu":
                self.bytes_to_host += t.numel() * t.element_size()
            return t.detach().cpu().numpy()

    def upload(self, a: np.ndarray, device) -> torch.Tensor:
        """A numpy array as a tensor of its dtype on ``device`` (a copy to
        the card does not wait for it, so it is not counted as a read)."""
        if torch.device(device).type != "cpu":
            self.bytes_to_device += a.nbytes
        # ascontiguousarray makes a 0-d array 1-d: keep the shape
        return torch.from_numpy(
            np.ascontiguousarray(a).reshape(np.shape(a))).to(device)


def _resolve_qn_storage(opt_value: str, compute_dtype):
    """Map the `qn_storage_dtype` option to a qn_init storage dtype."""
    if opt_value == "bfloat16":
        return torch.bfloat16
    if opt_value == "auto":
        return qnmod.default_storage_dtype(compute_dtype)
    return None


def _bound_pads(d: ProblemData, dprec, dtype):
    """Distance the clips keep x STRICTLY inside [lb, ub]: at least a few
    ulps of the bound's magnitude, since design_precision (1e-14) is below
    f32 resolution and a clip to lb + 1e-14 would leave x ON the bound."""
    eps = torch.finfo(dtype).eps
    lo = torch.clamp(4.0 * eps * (1.0 + torch.abs(d.lb)), min=dprec)
    hi = torch.clamp(4.0 * eps * (1.0 + torch.abs(d.ub)), min=dprec)
    return lo, hi


def _barrier_terms(x, s, t, sw, tw, d: ProblemData, rel_bound_barrier):
    """Sum of log-barrier terms (the φ part of the merit function,
    `evalMeritFunc`, `ParOptInteriorPoint.cpp:3524-3650`)."""
    total = rel_bound_barrier * (
        torch.sum(torch.where(d.lb_mask > 0,
                              torch.log(torch.clamp(x - d.lb, min=1e-300)),
                              0.0))
        + torch.sum(torch.where(d.ub_mask > 0,
                                torch.log(torch.clamp(d.ub - x, min=1e-300)),
                                0.0)))
    for arr in (s, t, sw, tw):
        if arr.numel():
            total = total + torch.sum(torch.log(torch.clamp(arr, min=1e-300)))
    return total


def _infeas_l2(c, s, t, cw, sw, tw):
    total = torch.zeros((), dtype=s.dtype, device=s.device)
    if c.numel():
        total = total + torch.sum((c - s + t) ** 2)
    if cw.numel():
        total = total + torch.sum((cw - sw + tw) ** 2)
    return torch.sqrt(total)


# ---------------------------------------------------------------------------
# the numerical phases of a major iteration (JAX jits each one)
# ---------------------------------------------------------------------------


def _residual_and_norms(v: IPVars, d: ProblemData, mu, rel_bound_barrier,
                        norm_type: str):
    """(prime, dual, infeas, res_norm, comp) scalars of the KKT residual."""
    r = kkt.kkt_residual(v, d, mu, rel_bound_barrier)
    prime = multi_norm([r.x, r.s, r.t], norm_type)
    dual = multi_norm([r.zl, r.zu, r.zs, r.zt, r.sw, r.tw, r.zsw, r.ztw],
                      norm_type)
    infeas = multi_norm([r.z, r.zw], norm_type)
    if norm_type == "infinity":
        res_norm = torch.maximum(prime, torch.maximum(dual, infeas))
    elif norm_type == "l1":
        res_norm = prime + dual + infeas
    else:
        res_norm = torch.sqrt(prime ** 2 + dual ** 2 + infeas ** 2)
    return prime, dual, infeas, res_norm, kkt.average_complementarity(v, d)


def _qn_term(compact, use_qn: bool):
    return compact if use_qn else (compact[0], None, None)


def _compute_step(v: IPVars, d: ProblemData, compact, mu, rel_bound_barrier,
                  qn_sigma, refine_steps: int, use_qn: bool,
                  csr_mat=None) -> IPVars:
    r = kkt.kkt_residual(v, d, mu, rel_bound_barrier)
    cq = _qn_term(compact, use_qn)
    f = kkt.setup_kkt_factor(v, d, qn_compact=cq, qn_sigma=qn_sigma,
                             csr_mat=csr_mat)
    return kkt.solve_kkt(v, d, f, r, refine_steps=refine_steps,
                         qn_compact=cq)


def _compute_step_mpc(v: IPVars, d: ProblemData, compact, mu,
                      rel_bound_barrier, qn_sigma, p_aff: IPVars,
                      refine_steps: int, use_qn: bool) -> IPVars:
    """Mehrotra predictor-corrector step: the complementarity residuals get
    the second-order Δ·Δ terms from the affine predictor
    (`ParOptInteriorPoint.cpp:4999-5051`)."""
    r = kkt.kkt_residual(v, d, mu, rel_bound_barrier)
    r = dataclasses.replace(
        r,
        zs=r.zs + p_aff.s * p_aff.zs,
        zt=r.zt + p_aff.t * p_aff.zt,
        zsw=r.zsw + p_aff.sw * p_aff.zsw,
        ztw=r.ztw + p_aff.tw * p_aff.ztw,
        zl=torch.where(d.lb_mask > 0, r.zl + p_aff.x * p_aff.zl, 0.0),
        zu=torch.where(d.ub_mask > 0, r.zu - p_aff.x * p_aff.zu, 0.0))
    cq = _qn_term(compact, use_qn)
    f = kkt.setup_kkt_factor(v, d, qn_compact=cq, qn_sigma=qn_sigma)
    return kkt.solve_kkt(v, d, f, r, refine_steps=refine_steps,
                         qn_compact=cq)


def _check_kkt_step(v: IPVars, d: ProblemData, p: IPVars, compact, mu,
                    rel_bound_barrier, qn_sigma, use_qn: bool):
    """Max per-equation error of K·p + r (`checkKKTStep`,
    `ParOptInteriorPoint.cpp:6212+`)."""
    r = kkt.kkt_residual(v, d, mu, rel_bound_barrier)
    Kp = kkt.apply_kkt_matrix(v, d, p, qn_compact=_qn_term(compact, use_qn),
                              qn_sigma=qn_sigma)
    err = tmap(torch.add, Kp, r)
    leaves = [torch.max(torch.abs(getattr(err, f.name)))
              for f in dataclasses.fields(err)
              if getattr(err, f.name).numel()]
    if not leaves:
        return torch.zeros((), dtype=v.x.dtype, device=v.x.device)
    return torch.max(torch.stack(leaves))


def _scale_step(v: IPVars, d: ProblemData, p: IPVars, mu, comp,
                tau_min=0.95, inexact: bool = False):
    """Fraction-to-boundary scaling with the equal-step safeguard
    (`scaleKKTStep`, `ParOptInteriorPoint.cpp:3196-3278`).  Returns
    (scaled step, ax, az, equalized).  An ``inexact`` (Newton-Krylov)
    step is always equalized and not reported as such."""
    tau = torch.clamp(1.0 - mu, min=tau_min)
    ax, az = kkt.max_step_lengths(v, d, p, tau)
    # bound the ratio between the two step lengths by 100 (clamp the larger)
    mb = 100.0
    ax = torch.where(ax > az, torch.clamp(ax, az / mb, az * mb), ax)
    az = torch.where(az > ax, torch.clamp(az, ax / mb, ax * mb), az)
    # if complementarity grows 10x at the scaled step, equalize
    comp_new = kkt.average_complementarity(v.axpy(ax, az, p), d)
    amin = torch.minimum(ax, az)
    ceq = comp_new > 10.0 * comp
    if inexact:
        ceq = torch.ones_like(ceq)
    ax = torch.where(ceq, amin, ax)
    az = torch.where(ceq, amin, az)
    return p.scaled(ax, az), ax, az, ceq & (not inexact)


def _merit_parts(v: IPVars, d: ProblemData, p: IPVars, fobj, mu,
                 rel_bound_barrier, compact, use_qn: bool):
    """Merit value/derivative pieces sans the ρ·infeasibility term
    (`evalMeritInitDeriv`, `ParOptInteriorPoint.cpp:3652-3938`).
    Returns (merit0, pmerit0, infeas, infeas_proj, pTBp)."""
    merit0 = (fobj
              + torch.sum(d.gamma_s * v.s) + torch.sum(d.gamma_t * v.t)
              + torch.sum(d.gamma_sw * v.sw) + torch.sum(d.gamma_tw * v.tw)
              - mu * _barrier_terms(v.x, v.s, v.t, v.sw, v.tw, d,
                                    rel_bound_barrier))
    pbarrier = rel_bound_barrier * (
        torch.sum(torch.where(d.lb_mask > 0, p.x / (v.x - d.lb), 0.0))
        - torch.sum(torch.where(d.ub_mask > 0, p.x / (d.ub - v.x), 0.0)))
    for val, st in ((v.s, p.s), (v.t, p.t), (v.sw, p.sw), (v.tw, p.tw)):
        if val.numel():
            pbarrier = pbarrier + torch.sum(st / val)
    pmerit0 = (dot(d.g, p.x)
               + torch.sum(d.gamma_s * p.s) + torch.sum(d.gamma_t * p.t)
               + torch.sum(d.gamma_sw * p.sw) + torch.sum(d.gamma_tw * p.tw)
               - mu * pbarrier)
    infeas = _infeas_l2(d.c, v.s, v.t, d.cw, v.sw, v.tw)
    # directional derivative of the l2 infeasibility
    proj = torch.zeros_like(infeas)
    if d.ncon:
        proj = proj + torch.sum((d.c - v.s + v.t) * (d.A @ p.x - p.s + p.t))
    if d.nwcon:
        proj = proj + torch.sum((d.cw - v.sw + v.tw)
                                * (d.Aw_matvec(p.x) - p.sw + p.tw))
    infeas_proj = torch.where(infeas > 0.0,
                              proj / torch.clamp(infeas, min=1e-300), 0.0)
    if use_qn:
        pTBp = dot(p.x, _bmult(compact, p.x))
    else:
        pTBp = torch.zeros_like(fobj)
    return merit0, pmerit0, infeas, infeas_proj, pTBp


def _bmult(compact, px):
    """B @ px for a Hessian in compact form (b0, Z, M): b0·px - Zᵀ M⁻¹ Z px
    (Z None or empty for a scalar or diagonal b0)."""
    b0, Z, M = compact
    out = b0 * px
    if Z is not None and Z.shape[0] > 0:
        out = out - matmul(Z.T,
                           torch.linalg.solve_ex(M, matmul(Z, px)).result)
    return out


def _nk_projections(v: IPVars, d: ProblemData, b: IPVars, p: IPVars, mu,
                    rel_bound_barrier):
    """Newton-Krylov descent-gate projections (paropt_tpu/ip.py:262-298):
    fproj, the barrier-objective directional derivative along p, and
    cproj, the constraint-residual projections normalized by
    1/||c-s+t|| and 1/||cw-sw+tw||.  ``b`` is the GMRES right-hand side."""
    pbarrier = rel_bound_barrier * (
        torch.sum(torch.where(d.lb_mask > 0, p.x / (v.x - d.lb), 0.0))
        - torch.sum(torch.where(d.ub_mask > 0, p.x / (d.ub - v.x), 0.0)))
    for val, st in ((v.s, p.s), (v.t, p.t), (v.sw, p.sw), (v.tw, p.tw)):
        if val.numel():
            pbarrier = pbarrier + torch.sum(st / val)
    fproj = (torch.dot(d.g, p.x)
             + torch.sum(d.gamma_s * p.s) + torch.sum(d.gamma_t * p.t)
             + torch.sum(d.gamma_sw * p.sw) + torch.sum(d.gamma_tw * p.tw)
             - mu * pbarrier)
    cproj = torch.zeros_like(fproj)

    def inv_or_zero(nrm):
        return torch.where(nrm != 0.0,
                           1.0 / torch.where(nrm != 0.0, nrm, 1.0), 0.0)

    if d.ncon:
        cscale = inv_or_zero(torch.linalg.norm(d.c - v.s + v.t))
        cproj = cproj - cscale * torch.sum(b.z * (d.A @ p.x - p.s + p.t))
    if d.nwcon:
        cwscale = inv_or_zero(torch.linalg.norm(d.cw - v.sw + v.tw))
        cproj = cproj - cwscale * torch.sum(
            b.zw * (d.Aw_matvec(p.x) - p.sw + p.tw))
    return fproj, cproj


def _back_substitute(H, g, k):
    """y solving the leading k x k upper-triangular system H y = g (a zero
    diagonal, GMRES's lucky breakdown, gives a zero entry)."""
    y = np.zeros(k)
    for i in range(k - 1, -1, -1):
        hd = H[i, i]
        y[i] = 0.0 if hd == 0.0 else (g[i] - H[i, i + 1:k] @ y[i + 1:k]) / hd
    return y


def _merit_eval(x, s, t, sw, tw, fobj, c, cw, d: ProblemData, mu,
                rel_bound_barrier, rho):
    """Merit at a trial point (`evalMeritFunc`)."""
    return (fobj
            + torch.sum(d.gamma_s * s) + torch.sum(d.gamma_t * t)
            + torch.sum(d.gamma_sw * sw) + torch.sum(d.gamma_tw * tw)
            - mu * _barrier_terms(x, s, t, sw, tw, d, rel_bound_barrier)
            + rho * _infeas_l2(c, s, t, cw, sw, tw))


def _clip_x(x, d: ProblemData, design_precision):
    lo_pad, hi_pad = _bound_pads(d, design_precision, x.dtype)
    x = torch.where((d.lb_mask > 0) & (x <= d.lb + lo_pad), d.lb + lo_pad, x)
    return torch.where((d.ub_mask > 0) & (x + hi_pad >= d.ub),
                       d.ub - hi_pad, x)


def _apply_step(v: IPVars, d: ProblemData, p: IPVars, alpha,
                design_precision) -> IPVars:
    """vars + α·p with strict-interior clipping (`computeStepVec`,
    `ParOptInteriorPoint.cpp:3122-3194`): x clipped to [lb+pad, ub-pad]
    where bounded; slack/positivity variables clipped at dp."""
    vn = v.axpy(alpha, alpha, p)

    def clip0(a):
        return torch.clamp(a, min=design_precision)

    return IPVars(x=_clip_x(vn.x, d, design_precision),
                  zl=torch.where(d.lb_mask > 0, clip0(vn.zl), 0.0),
                  zu=torch.where(d.ub_mask > 0, clip0(vn.zu), 0.0),
                  s=clip0(vn.s), t=clip0(vn.t), z=vn.z, zs=clip0(vn.zs),
                  zt=clip0(vn.zt), sw=clip0(vn.sw), tw=clip0(vn.tw),
                  zw=vn.zw, zsw=clip0(vn.zsw), ztw=clip0(vn.ztw))


def _trial_point(v: IPVars, d: ProblemData, p: IPVars, alpha,
                 design_precision):
    """(x, s, t, sw, tw) at v + α·p with the same clipping as _apply_step."""
    x = _clip_x(v.x + alpha * p.x, d, design_precision)

    def clip(a):
        return torch.clamp(a, min=design_precision)

    return (x, clip(v.s + alpha * p.s), clip(v.t + alpha * p.t),
            clip(v.sw + alpha * p.sw), clip(v.tw + alpha * p.tw))


def _own_state(solver, *_):
    """The state an `InteriorPoint` method may hold sharded (`spmd`)."""
    return solver.vars


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------


class InteriorPoint:
    """Interior-point method, usable standalone or as the subproblem solver
    of the trust-region and MMA outer loops.

    ``problem``: a `paropt_torch.Problem`; its x0 sets the device of every
    tensor the solver makes.  ``options``: a dict or OptionRegistry with
    the reference's option names (``output_file`` None writes no log).
    Constructing a solver turns TF32 off for float32 matrix products and
    convolutions, as `FusedIP` does."""

    @spmd
    def __init__(self, problem, options: Optional[Any] = None):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.problem = problem
        if isinstance(options, OptionRegistry):
            self.options = options
        else:
            self.options = make_options(options, which="ip")
        o = self.options
        self.dtype = torch.float64 if o["dtype"] == "float64" \
            else torch.float32
        # a CSR problem counts its own reads (its Jacobian fills) here too
        self.syncs = getattr(problem, "syncs", None) or HostSyncs()

        # counters (`getIterationCounters`, ParOptInteriorPoint.h:203-217)
        self.niter = 0
        self.neval = 0
        self.ngeval = 0
        self.nhvec = 0

        # bounds + design variables (these fix the device)
        self._init_design_and_bounds()

        # penalties (ParOptInteriorPoint.cpp:343-374): inequality
        # constraints get gamma_s = 0; equalities get both
        gamma = o["penalty_gamma"]
        ncon, nwcon = problem.ncon, problem.nwcon
        nineq, nwineq = problem.ninequality, problem.nwinequality
        self.gamma_s = self._tensor(
            np.where(np.arange(ncon) < nineq, 0.0, gamma))
        self.gamma_t = torch.full((ncon,), gamma, **self._kw)
        self.gamma_sw = self._tensor(
            np.where(np.arange(nwcon) < nwineq, 0.0, gamma))
        self.gamma_tw = torch.full((nwcon,), gamma, **self._kw)

        self.mu = o["init_barrier_param"]
        self.rho_penalty = o["init_rho_penalty_search"]

        # quasi-Newton state, held in a shared mutable holder so an outer
        # loop (trust region) and this optimizer see the same approximation
        self._qn_holder: Dict[str, Any] = {"state": None}
        self._make_qn()

        self._eval_exc_warned = False

        # current evaluation cache
        self.fobj = None
        self.c = None
        self.g = None
        self.A = None
        self.cw = None

        self.vars: Optional[IPVars] = None
        self._init_vars()

        # general-CSR constraints: the host sparse factor of Cw
        self._csr_mat = None
        if getattr(problem, "use_csr_path", False):
            self._csr_mat = kkt.HostCSRFactor(problem.create_quasi_def_mat(),
                                              self.syncs)
        # no structured Jacobian: the callback products.  Only the "not
        # provided" signal demotes a problem to them; any other error of
        # the user's sparse_jacobian propagates
        self._callback_sparse = False
        if nwcon > 0 and self._csr_mat is None:
            try:
                problem.sparse_jacobian(self.x0)
            except NotImplementedError:
                self._callback_sparse = True
        self._eager = self._csr_mat is not None or self._callback_sparse

        self._logger = None
        self._converged_reason = ""

    @property
    def _kw(self):
        return dict(dtype=self.dtype, device=self.device)

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(a, **self._kw)

    def _scalar(self, val) -> torch.Tensor:
        return torch.tensor(val, **self._kw)

    # -- setup ---------------------------------------------------------------

    @property
    def qn(self):
        return self._qn_holder["state"]

    @qn.setter
    def qn(self, state):
        self._qn_holder["state"] = state

    def _make_qn(self):
        o = self.options
        qt = o["qn_type"]
        if qt == "none" or o["sequential_linear_method"]:
            self.qn = None
            return
        msub = qnmod.resolve_subspace_size(
            o["qn_subspace_size"], o["qn_subspace_auto"],
            self.problem.nvars, self.dtype)
        if msub <= 0:
            self.qn = None
            return
        self.qn = qnmod.qn_init(
            msub, self.problem.nvars, dtype=self.dtype, qn_type=qt,
            storage_dtype=_resolve_qn_storage(o["qn_storage_dtype"],
                                              self.dtype),
            update_type=o["qn_update_type"], diag_type=o["qn_diag_type"],
            device=self.device)

    def set_quasi_newton_holder(self, holder: Dict[str, Any]):
        """Share a mutable {'state': QNState} holder with an outer loop
        (`ParOptInteriorPoint::setQuasiNewton`)."""
        self._qn_holder = holder

    def set_penalty_gamma(self, gamma, gamma_sparse=None):
        """Set the l1 elastic penalties, scalar or per-constraint
        (`ParOptInteriorPoint::setPenaltyGamma`).  Inequality constraints
        keep gamma_s = 0."""
        ncon, nwcon = self.problem.ncon, self.problem.nwcon
        g = self._tensor(gamma).broadcast_to((ncon,)).clone()
        idx = torch.arange(ncon, device=self.device)
        self.gamma_s = torch.where(idx < self.problem.ninequality, 0.0, g)
        self.gamma_t = g
        if gamma_sparse is None:
            ndim = gamma.ndim if hasattr(gamma, "ndim") else np.ndim(gamma)
            gamma_sparse = gamma if ndim == 0 else None
        if gamma_sparse is not None and nwcon > 0:
            gw = self._tensor(gamma_sparse).broadcast_to((nwcon,)).clone()
            idxw = torch.arange(nwcon, device=self.device)
            self.gamma_sw = torch.where(idxw < self.problem.nwinequality,
                                        0.0, gw)
            self.gamma_tw = gw

    def _init_design_and_bounds(self):
        """`initAndCheckDesignAndBounds` (`ParOptInteriorPoint.cpp:4277+`)."""
        o = self.options
        x, lb, ub = self.problem.get_vars_and_bounds()
        self.device = (x.device if isinstance(x, torch.Tensor)
                       else resolve_device(None))
        x, lb, ub = self._tensor(x), self._tensor(lb), self._tensor(ub)
        if is_sharded(x):
            # a design vector sharded over a device mesh: the bounds take
            # its placements, and every n-sized array follows them
            lb, ub = (b if is_sharded(b) else place_like(b, x)
                      for b in (lb, ub))
        mbv = o["max_bound_value"]
        self.lb_mask = (lb > -mbv).to(self.dtype)
        self.ub_mask = (ub < mbv).to(self.dtype)
        # clip strictly inside the bounds (dtype-aware pad, see _bound_pads)
        eps4 = 4.0 * torch.finfo(self.dtype).eps
        dp = o["design_precision"]
        lo_pad = torch.clamp(eps4 * (1.0 + torch.abs(lb)), min=dp)
        hi_pad = torch.clamp(eps4 * (1.0 + torch.abs(ub)), min=dp)
        x = torch.where((self.lb_mask > 0) & (x < lb + lo_pad), lb + lo_pad,
                        x)
        x = torch.where((self.ub_mask > 0) & (x > ub - hi_pad), ub - hi_pad,
                        x)
        self.x0, self.lb, self.ub = x, lb, ub

    def reset_design_and_bounds(self):
        """Re-query the problem for x/bounds (TR calls this between
        subproblem solves, `resetDesignAndBounds`)."""
        self._init_design_and_bounds()
        if self.vars is not None:
            self.vars = dataclasses.replace(self.vars, x=self.x0)

    def _init_vars(self):
        ncon, nwcon = self.problem.ncon, self.problem.nwcon
        one_c = torch.ones(ncon, **self._kw)
        one_w = torch.ones(nwcon, **self._kw)
        ones = torch.ones_like(self.x0)
        self.vars = IPVars(
            x=self.x0,
            zl=torch.where(self.lb_mask > 0, ones, 0.0),
            zu=torch.where(self.ub_mask > 0, ones, 0.0),
            s=one_c, t=one_c, z=torch.zeros(ncon, **self._kw),
            zs=one_c, zt=one_c,
            sw=one_w, tw=one_w, zw=torch.zeros(nwcon, **self._kw),
            zsw=one_w, ztw=one_w)

    # -- user evaluation wrappers -------------------------------------------

    def _eval_obj_con(self, x) -> Tuple[Any, Any, Any]:
        """-> (fobj, c, cw) or (None,)*3 on failure.  Any exception raised
        by the user callbacks maps to the fail path, as the reference
        treats any nonzero fail flag (`ParOptInteriorPoint.cpp:4019-4026`);
        only the callbacks sit inside the try."""
        try:
            fobj, c = self.problem.eval_obj_con(x)
            cw_raw = (self.problem.eval_sparse_con(x)
                      if self.problem.nwcon > 0 else None)
        except Exception as exc:  # user-callback failure -> fail flag
            if not self._eval_exc_warned:
                self._eval_exc_warned = True
                warnings.warn(
                    "objective/constraint evaluation raised "
                    f"{type(exc).__name__}: {exc}; treating as a failed "
                    "evaluation (fail flag)", RuntimeWarning)
            return None, None, None
        self.neval += 1
        fobj = self._tensor(fobj)
        c = self._tensor(c).reshape(self.problem.ncon)
        cw = (self._tensor(cw_raw).reshape(self.problem.nwcon)
              if cw_raw is not None else torch.zeros(0, **self._kw))
        finite = (torch.isfinite(fobj) & torch.all(torch.isfinite(c))
                  & torch.all(torch.isfinite(cw)))
        if not self.syncs(finite):
            return None, None, None
        return fobj, c, cw

    def _eval_gradients(self, x):
        try:
            g, A = self.problem.eval_obj_con_gradient(x)
        except Exception as exc:
            # gradient failure is fatal in the reference too
            # ("Gradient evaluation failed", ParOptInteriorPoint.cpp:4230)
            raise RuntimeError(
                f"gradient evaluation failed: {type(exc).__name__}: {exc}"
            ) from exc
        self.ngeval += 1
        return (self._tensor(g),
                self._tensor(A).reshape(self.problem.ncon,
                                        self.problem.nvars))

    def _from_user(self, a) -> torch.Tensor:
        """A user callback's result in the solve's dtype on its device,
        its bytes counted when it arrives from the host."""
        if not isinstance(a, torch.Tensor):
            a = self.syncs.upload(np.asarray(a), self.device)
        return self._tensor(a)

    def _callbacks(self):
        """(matvec, rmatvec, inner_blocks) of the problem's sparse operator
        at the current point; a batch of vectors goes one row at a time."""
        prob, x_cur = self.problem, self.vars.x

        def rows(fn):
            def apply(b):
                if b.dim() == 1:
                    return self._from_user(fn(x_cur, b))
                return torch.stack([self._from_user(fn(x_cur, row))
                                    for row in b])
            return apply

        return (rows(prob.sparse_jacobian_vec),
                rows(prob.sparse_jacobian_tvec),
                lambda dv: self._from_user(prob.sparse_inner_product(x_cur,
                                                                     dv)))

    def _make_data(self) -> ProblemData:
        prob = self.problem
        callbacks = None
        Aw_cols = Aw_vals = None
        nwblock, layout = 1, "gather"
        if prob.nwcon > 0 and self._callback_sparse:
            callbacks, nwblock = self._callbacks(), prob.nwblock
        elif prob.nwcon > 0:
            Aw = prob.sparse_jacobian(self.vars.x)
            Aw_cols, Aw_vals = Aw.cols, self._tensor(Aw.vals)
            nwblock, layout = prob.nwblock, Aw.layout
            if self._csr_mat is not None:
                self._csr_mat.set_values(prob._data)
        return ProblemData(
            g=self.g, A=self.A, c=self.c, cw=self.cw, lb=self.lb, ub=self.ub,
            lb_mask=self.lb_mask, ub_mask=self.ub_mask,
            gamma_s=self.gamma_s, gamma_t=self.gamma_t,
            gamma_sw=self.gamma_sw, gamma_tw=self.gamma_tw,
            Aw_cols=Aw_cols, Aw_vals=Aw_vals, nwblock=nwblock,
            Aw_layout=layout, Aw_callbacks=callbacks)

    # -- multiplier initialization ------------------------------------------

    def _init_least_squares_multipliers(self, d: ProblemData):
        """`initLeastSquaresMultipliers` (`ParOptInteriorPoint.cpp:
        5336-5534`): set everything to μ0, then solve the regularized
        least-squares system for (z, zw) and clamp outliers to zero."""
        mu0 = self.options["init_barrier_param"]
        v = self.vars
        ncon, nwcon = d.ncon, d.nwcon
        kw = self._kw
        full_n = torch.full_like(v.x, mu0)
        full_c = torch.full((ncon,), mu0, **kw)
        full_w = torch.full((nwcon,), mu0, **kw)
        v = IPVars(
            x=v.x, zl=torch.where(d.lb_mask > 0, full_n, 0.0),
            zu=torch.where(d.ub_mask > 0, full_n, 0.0),
            s=full_c, t=full_c, z=full_c, zs=full_c, zt=full_c,
            sw=full_w, tw=full_w, zw=full_w, zsw=full_w, ztw=full_w)

        small = 1e-4
        rhs = -(d.g - v.zl + v.zu)
        ones = torch.ones_like(v.x)
        if self._csr_mat is not None:
            # C = small in float64, as JAX's x64 default makes it
            self._csr_mat.set_values(self.problem._data)
            self._csr_mat.factor(ones, torch.full(
                (nwcon,), small, dtype=torch.float64, device=self.device))
        if nwcon > 0:
            nb = d.nwblock
            Cw = d.Aw_inner_blocks(ones)
            Cw_chol = (torch.sqrt(small + Cw) if nb == 1 else
                       torch.linalg.cholesky_ex(
                           Cw + small * torch.eye(nb, **kw)).L)
        else:
            Cw_chol = None
        # quasi-definite system with D = I, C = small
        f0 = kkt.KKTFactor(Dinv=ones, Gamma=None, C0=None, Cw_chol=Cw_chol,
                           Xa=None, Wa=None, G_lu=None, Zqn=None, Phi_x=None,
                           Phi_z=None, Phi_w=None, Ce_inv=None,
                           csr_solver=self._csr_mat)
        zw0 = torch.zeros(nwcon, **kw)
        if ncon > 0:
            Xa, _ = kkt.quasi_def_solve(f0, d, d.A,
                                        torch.zeros((ncon, nwcon), **kw))
            G = d.A @ Xa.T + small * torch.eye(ncon, **kw)
            yx0, _ = kkt.quasi_def_solve(f0, d, rhs, zw0)
            z = torch.linalg.solve_ex(G, -(d.A @ yx0)).result
            gmax = 10.0 * torch.maximum(d.gamma_s, d.gamma_t)
            z = torch.where((z < -gmax) | (z > gmax), 0.0, z)
        else:
            z = torch.zeros(0, **kw)
        if nwcon > 0:
            rx = rhs + d.A.T @ z if ncon else rhs
            _, zw_neg = kkt.quasi_def_solve(f0, d, rx, zw0)
            zw = -zw_neg
            gwmax = 10.0 * torch.maximum(d.gamma_sw, d.gamma_tw)
            zw = torch.where((zw < -gwmax) | (zw > gwmax), 0.0, zw)
        else:
            zw = torch.zeros(0, **kw)
        self.vars = dataclasses.replace(v, z=z, zw=zw)

    def _init_affine_step_multipliers(self, d: ProblemData):
        """`initAffineStepMultipliers` (`ParOptInteriorPoint.cpp:5536-5667`):
        least-squares estimate, then one μ=0 KKT step; slacks/multipliers set
        to |v + p| floored at start_affine_multiplier_min; μ0 from the
        resulting complementarity."""
        o = self.options
        self._init_least_squares_multipliers(d)
        v = self.vars
        use_qn = (self.qn is not None and bool(o["use_qn_gmres_precon"])
                  and not o["sequential_linear_method"]
                  and not o["use_diag_hessian"])
        p = _compute_step(v, d, self._qn_compact(), self._scalar(0.0),
                          o["rel_bound_barrier"], o["qn_sigma"], 0, use_qn,
                          self._csr_mat)
        amin = o["start_affine_multiplier_min"]

        def aff(val, st, mask=None):
            out = torch.clamp(torch.abs(val + st), min=amin)
            if mask is not None:
                out = torch.where(mask > 0, out, 0.0)
            return out

        self.vars = IPVars(
            x=v.x,
            zl=aff(v.zl, p.zl, d.lb_mask), zu=aff(v.zu, p.zu, d.ub_mask),
            s=aff(v.s, p.s), t=aff(v.t, p.t), z=v.z + p.z,
            zs=aff(v.zs, p.zs), zt=aff(v.zt, p.zt),
            sw=aff(v.sw, p.sw), tw=aff(v.tw, p.tw), zw=v.zw + p.zw,
            zsw=aff(v.zsw, p.zsw), ztw=aff(v.ztw, p.ztw))
        self.mu = self.syncs.value(kkt.average_complementarity(self.vars, d))

    # -- helpers -------------------------------------------------------------

    def _reset_qn(self):
        """Reset whichever Hessian approximation is installed (a QNState or
        a duck-typed provider with ``reset()``)."""
        if self.qn is None:
            return
        if isinstance(self.qn, qnmod.QNState):
            self.qn = qnmod.qn_reset(self.qn)
        else:
            self.qn.reset()

    def _qn_compact(self):
        if self.qn is not None and not isinstance(self.qn, qnmod.QNState):
            # duck-typed compact provider
            return self.qn.compact()
        if self.qn is not None:
            return qnmod.qn_compact(self.qn)
        # Without a QN the Hessian block is b0·I: zero for the sequential
        # linear method (the bound/barrier terms keep the KKT diagonal SPD
        # inside the TR box), identity otherwise.
        b0 = 0.0 if self.options["sequential_linear_method"] else 1.0
        return (self._scalar(b0), None, None)

    def _rho_update(self, merit0, pmerit0, infeas, infeas_proj, pTBp, max_x):
        """Penalty parameter ρ update (`evalMeritInitDeriv` tail,
        `ParOptInteriorPoint.cpp:3838-3920`) on host floats.
        Returns (m0, dm0)."""
        o = self.options
        descent = o["penalty_descent_fraction"]
        abs_res_tol = o["abs_res_tol"]
        numer = pmerit0
        if pTBp > 0.0:
            numer += 0.5 * pTBp
        if infeas < 0.1 * abs_res_tol:
            denom = -(1.0 - descent) * max_x * infeas
            rho_hat = -numer / denom if (numer >= 0.0 and denom < 0.0) else 0.0
        else:
            denom = infeas_proj + descent * max_x * infeas
            if numer >= 0.0:
                if denom < 0.0:
                    rho_hat = -numer / denom
                else:
                    denom = -(1.0 - descent) * max_x * infeas
                    rho_hat = -numer / denom if denom < 0.0 else 0.0
            else:
                rho_hat = 0.0
        if rho_hat > self.rho_penalty:
            self.rho_penalty = rho_hat
        else:
            self.rho_penalty = max(0.5 * self.rho_penalty, rho_hat)
        self.rho_penalty = max(self.rho_penalty,
                               o["min_rho_penalty_search"])
        m0 = merit0 + self.rho_penalty * infeas
        if infeas < 0.1 * abs_res_tol:
            dm0 = pmerit0 - self.rho_penalty * max_x * infeas
        else:
            dm0 = pmerit0 + self.rho_penalty * infeas_proj
        return m0, dm0

    def _eval_merit_at(self, d, alpha, p):
        """The merit function at v + α·p.  Returns (merit, trial) where
        trial = (x, s, t, sw, tw, fobj, c, cw), or (None, None) if the user
        evaluation failed."""
        o = self.options
        xt, st, tt, swt, twt = _trial_point(self.vars, d, p,
                                            self._scalar(alpha),
                                            o["design_precision"])
        fobj, c, cw = self._eval_obj_con(xt)
        if fobj is None:
            return None, None
        m = _merit_eval(xt, st, tt, swt, twt, fobj, c, cw, d,
                        self._scalar(self.mu), o["rel_bound_barrier"],
                        self._scalar(self.rho_penalty))
        return self.syncs.value(m), (xt, st, tt, swt, twt, fobj, c, cw)

    @spmd(probe=_own_state)
    def check_merit_func_gradient(self, xpt=None, dh: float = 1e-6, p=None):
        """FD verification of the merit directional derivative used by the
        line search (`checkMeritFuncGradient`,
        `ParOptInteriorPoint.cpp:3280-3436`).

        Evaluates f/c and gradients at ``xpt`` (or the current point),
        computes (m0, dm0) along a probe direction through the same
        ρ-penalty update the line search uses (max_x = 1), then compares
        dm0 against the forward difference (m(dh) - m0) / dh.  The direction
        is ``p`` (an IPVars: the in-loop caller passes the scaled KKT step)
        or the reference's deterministic test direction: px = -g/|g| with
        fixed patterned slack components (`:3325-3350`).

        Returns (fd, dm0, abs_err, rel_err) and logs one line in the
        reference's ``Merit function test`` format."""
        o = self.options
        if self.vars is None:
            self._init_design_and_bounds()
            self._init_vars()
        if xpt is not None:
            self.vars = dataclasses.replace(self.vars, x=self._tensor(xpt))
        self.fobj, self.c, self.cw = self._eval_obj_con(self.vars.x)
        if self.fobj is None:
            raise RuntimeError("function evaluation failed")
        self.g, self.A = self._eval_gradients(self.vars.x)
        d = self._make_data()
        ncon, nwcon = self.problem.ncon, self.problem.nwcon
        if p is None:
            # the reference's deterministic probe direction
            gnorm = self.syncs.value(torch.linalg.norm(d.g)) or 1.0
            ic = np.arange(ncon)
            iw = np.arange(nwcon)
            zc = torch.zeros(ncon, **self._kw)
            zwv = torch.zeros(nwcon, **self._kw)
            p = IPVars(
                x=d.g / -gnorm,
                zl=torch.zeros_like(self.vars.zl),
                zu=torch.zeros_like(self.vars.zu),
                s=self._tensor(-0.259 * (1 + ic % 3)),
                t=self._tensor(-0.349 * (4 - ic % 2)),
                z=zc, zs=zc, zt=zc,
                sw=self._tensor(-0.419 * (1 + iw % 5)),
                tw=self._tensor(-0.7513 * (1 + iw % 19)),
                zw=zwv, zsw=zwv, ztw=zwv)
        use_qn = (self.qn is not None
                  and not o["sequential_linear_method"])
        mu = self._scalar(self.mu)
        mp = _merit_parts(self.vars, d, p, self.fobj, mu,
                          o["rel_bound_barrier"], self._qn_compact(), use_qn)
        m0, dm0 = self._rho_update(*self.syncs.values(*mp), 1.0)

        # forward probe of all merit-relevant components (no clipping —
        # the reference perturbs the raw variables, `:3381-3394`)
        v = self.vars
        ftemp, rc, rcw = self._eval_obj_con(v.x + dh * p.x)
        if ftemp is None:
            raise RuntimeError("function evaluation failed")
        m1 = self.syncs.value(_merit_eval(
            v.x + dh * p.x, v.s + dh * p.s, v.t + dh * p.t,
            v.sw + dh * p.sw, v.tw + dh * p.tw, ftemp, rc, rcw, d, mu,
            o["rel_bound_barrier"], self._scalar(self.rho_penalty)))
        fd = (m1 - m0) / dh
        abs_err = abs(fd - dm0)
        rel_err = abs_err / max(abs(fd), 1e-300)
        line = ("Merit function test\n"
                f"dm FD: {fd:15.8e}  Actual: {dm0:15.8e}  "
                f"Err: {abs_err:8.2e}  Rel err: {rel_err:8.2e}\n")
        if self._logger is not None:
            self._logger.write(line)
        else:
            print(line, end="")
        return fd, dm0, abs_err, rel_err

    def _line_search(self, d, p, alpha_min, m0, dm0):
        """Backtracking / quadratic-interpolation merit line search
        (`lineSearch`, `ParOptInteriorPoint.cpp:3939-4160`).
        Returns (fail_flags, alpha, trial-or-None)."""
        o = self.options
        max_iters = o["max_line_iters"]
        backtrack = o["use_backtracking_alpha"]
        armijo = o["armijo_constant"]
        fprec = o["function_precision"]

        alpha = 1.0
        fail = LS_FAILURE
        best_alpha = -1.0
        best_merit = 0.0
        best_trial = None
        merit = None
        verbose = o["output_level"] > 0 and self._logger is not None
        if verbose:
            # reference per-trial trace (`ParOptInteriorPoint.cpp:3986-3994`)
            pxnorm = (self.syncs.value(torch.max(torch.abs(p.x)))
                      if p.x.numel() else 0.0)
            self._logger.write(
                "%5s %7s %25s %12s %12s %12s\n"
                % ("iter", "alpha", "merit", "dmerit", "||px||",
                   "min(alpha)"))
            self._logger.write("%5d %7s %25.16e %12.5e %12.5e %12.5e\n"
                               % (0, " ", m0, dm0, pxnorm, alpha_min))
        j = 0
        trial = None
        while j < max_iters:
            merit, trial = self._eval_merit_at(d, alpha, p)
            if merit is None:
                alpha *= 0.1
                j += 1
                continue
            if verbose:
                self._logger.write(
                    "%5d %7.1e %25.16e %12.5e\n"
                    % (j + 1, alpha, merit, (merit - m0) / alpha))
            if best_alpha < 0.0 or merit < best_merit:
                best_alpha, best_merit, best_trial = alpha, merit, trial
            # Armijo relaxed by the function precision
            if merit - armijo * alpha * dm0 < m0 + fprec:
                fail = (LS_SUCCESS | LS_MIN_STEP if (fail & LS_MIN_STEP)
                        else LS_SUCCESS)
                if (merit <= m0 + fprec) and (merit + fprec >= m0):
                    fail |= LS_NO_IMPROVEMENT
                break
            elif fail & LS_MIN_STEP:
                break
            if j < max_iters - 1:
                if backtrack:
                    alpha = 0.5 * alpha
                    if alpha <= alpha_min:
                        alpha = alpha_min
                        fail |= LS_MIN_STEP
                else:
                    denom = merit - m0 - dm0 * alpha
                    alpha_new = (-0.5 * dm0 * alpha * alpha / denom
                                 if denom != 0.0 else alpha_min)
                    if alpha_new <= alpha_min:
                        alpha = alpha_min
                        fail |= LS_MIN_STEP
                    elif alpha_new < 0.01 * alpha:
                        alpha = 0.01 * alpha
                    else:
                        alpha = alpha_new
            j += 1
        if j == max_iters:
            fail |= LS_MAX_ITERS
        trial_out = best_trial
        if not (fail & LS_SUCCESS):
            if best_merit <= m0 + fprec and best_alpha > 0:
                fail |= LS_SUCCESS
                fail &= ~LS_FAILURE
            elif (merit is not None and merit <= m0 + fprec
                  and merit + fprec >= m0):
                fail |= LS_NO_IMPROVEMENT
            alpha = best_alpha if best_alpha > 0 else alpha
        else:
            trial_out = trial if (fail & LS_SUCCESS) and merit is not None \
                else best_trial
        return fail, alpha, trial_out

    def _accept_step(self, d, alpha, p, trial, perform_qn_update=True):
        """`computeStepAndUpdate` (`ParOptInteriorPoint.cpp:4169-4270`):
        apply the step, refresh gradients, update the quasi-Newton pair
        y = ∇ₓL(x₊, z₊) − ∇ₓL(x₀, z₊), s = α·px."""
        o = self.options
        v = self.vars
        new_vars = _apply_step(v, d, p, self._scalar(alpha),
                               o["design_precision"])
        if trial is not None:
            # reuse function values from the line search
            xt, st, tt, swt, twt, fobj, c, cw = trial
            new_vars = dataclasses.replace(new_vars, x=xt, s=st, t=tt,
                                           sw=swt, tw=twt)
            self.fobj, self.c, self.cw = fobj, c, cw
        else:
            fobj, c, cw = self._eval_obj_con(new_vars.x)
            if fobj is None:
                return False, 0, 0
            self.fobj, self.c, self.cw = fobj, c, cw

        g_old, A_old, x_old = self.g, self.A, v.x
        do_qn = (self.qn is not None and perform_qn_update
                 and o["use_quasi_newton_update"])
        z_new, zw_new = new_vars.z, new_vars.zw
        # the old-point Lagrangian gradient must be formed BEFORE the new
        # gradient evaluation: stateful problems overwrite their stored
        # Jacobian on evaluation (`computeStepAndUpdate` ordering,
        # ParOptInteriorPoint.cpp:4199-4216)
        if do_qn:
            y_old = g_old - A_old.T @ z_new if d.ncon else g_old
            if d.nwcon > 0:
                y_old = y_old - self.problem.sparse_jacobian_tvec(x_old,
                                                                  zw_new)
        self.g, self.A = self._eval_gradients(new_vars.x)
        skipped = damped = 0
        if (self.qn is not None and perform_qn_update
                and not o["use_quasi_newton_update"]
                and hasattr(self.qn, "update_multipliers")):
            # refresh the multiplier-dependent pieces of an externally
            # managed Hessian approximation (qn->update(x, z, zw) at
            # ParOptInteriorPoint.cpp:4263)
            self.qn.update_multipliers(new_vars.x, new_vars.z, new_vars.zw)
        if do_qn:
            y = self.g - self.A.T @ z_new if d.ncon else self.g
            if d.nwcon > 0:
                y = y - self.problem.sparse_jacobian_tvec(new_vars.x, zw_new)
            y = y - y_old
            s_step = alpha * p.x
            s_step, y = self.problem.compute_quasi_newton_update_correction(
                new_vars.x, z_new, zw_new, s_step, y)
            z0 = z_new[0] if (self.qn.scaled and d.ncon > 0) else None
            self.qn, skipped_t, damped_t = qnmod.qn_update(self.qn, s_step,
                                                           y, z0=z0)
            skipped, damped = (int(f) for f in
                               self.syncs.values(skipped_t, damped_t))
        self.vars = new_vars
        return True, skipped, damped

    # -- Newton-Krylov (GMRES) inexact phase --------------------------------

    def _gmres_step(self, d, mu_j, compact, rtol):
        """Right-preconditioned GMRES on the exact KKT linearization with
        the problem's Hessian-vector products (paropt_tpu/ip.py:1052-1225,
        `computeKKTGMRESStep`).  The preconditioner is the KKT factor (with
        the quasi-Newton Hessian when `use_qn_gmres_precon`); each Krylov
        vector is stored as an x-vector w and one scalar a (the full
        vector N·w + (a/‖b‖)·(I-NNᵀ)·b), so dots are wᵢᵀwⱼ + β·aᵢaⱼ with
        β = ‖b_nonx‖²/‖b‖².  Returns (step, arms run) or (None, arms run)
        when GMRES fails or the assembled step is not a descent direction.

        JAX reads each modified Gram-Schmidt dot on the host as it goes;
        here one arm's dots are formed on the device in float64 (the
        vector dot in the solve's dtype, as in JAX) and read with the
        arm's norm and projections in one transfer.  The Givens
        rotations, back-substitution and gates run on the host in float64,
        as in JAX."""
        o = self.options
        v = self.vars
        m = o["gmres_subspace_size"]
        atol = o["gmres_atol"]
        rbb = o["rel_bound_barrier"]
        f64 = torch.float64
        r = kkt.kkt_residual(v, d, mu_j, rbb)
        b = tmap(torch.neg, r)

        use_qn = (self.qn is not None and bool(o["use_qn_gmres_precon"])
                  and not o["sequential_linear_method"])
        cq = compact if use_qn else (compact[0], None, None)
        f = kkt.setup_kkt_factor(v, d, qn_compact=cq, qn_sigma=o["qn_sigma"],
                                 csr_mat=self._csr_mat)

        def precon(w):
            return kkt.solve_kkt(v, d, f, tmap(torch.neg, w), qn_compact=cq)

        leaves = [getattr(b, fl.name) for fl in dataclasses.fields(b)]
        zero = torch.zeros((), dtype=f64, device=self.device)
        cinf = (torch.linalg.norm(d.c - v.s + v.t) if d.ncon else zero)
        cwinf = (torch.linalg.norm(d.cw - v.sw + v.tw) if d.nwcon else zero)
        bsq, bxx, cinfeas, cwinfeas = self.syncs.values(
            sum(dot(a, a) for a in leaves), dot(b.x, b.x), cinf, cwinf)
        bnorm = float(np.sqrt(bsq))
        if bnorm == 0.0:
            return None, 0
        beta_n = (bsq - bxx) / (bnorm * bnorm)

        def embed(wx, a):
            scale = a / bnorm
            return dataclasses.replace(tmap(lambda leaf: scale * leaf, b),
                                       x=wx)

        verbose = o["output_level"] > 0 and self._logger is not None
        if verbose:
            # the reference's GMRES trace (`ParOptInteriorPoint.cpp:
            # 5904-5910`)
            self._logger.write(
                "%5s %4s %4s %7s %7s %8s %8s gmres rtol: %7.1e\n"
                % ("gmres", "nhvc", "iter", "res", "rel", "fproj",
                   "cproj", rtol))
            self._logger.write("      %4d %4d %7.1e %7.1e\n"
                               % (self.nhvec, 0, bnorm, 1.0))
        fproj: list = []
        cproj: list = []
        # the tolerance exit is taken only for a candidate descent direction
        # (`:6058-6069`): fpr < 0, or the constraint projection reduces the
        # l2 infeasibility by at least 1% of its magnitude
        descent_thresh = -0.01 * (cinfeas + cwinfeas)

        W = [b.x / bnorm]
        al = [1.0]
        H = np.zeros((m + 1, m))
        g_vec = np.zeros(m + 1)
        g_vec[0] = bnorm
        cs = np.zeros(m)
        sn = np.zeros(m)
        iters = 0
        for j in range(m):
            # z_j = K_B⁻¹ v̂_j (transient); K z_j = v̂_j + N(H-B)z_j.x
            zj = precon(embed(W[j], al[j]))
            fp, cp = _nk_projections(v, d, b, zj, mu_j, rbb)
            hvp = self._tensor(self.problem.eval_hvec_product(
                v.x, v.z, v.zw, zj.x))
            self.nhvec += 1
            w = W[j] + (hvp - _bmult(cq, zj.x))
            # modified Gram-Schmidt, on the device, read once per arm
            a = torch.tensor(al[j], dtype=f64, device=self.device)
            hcol = []
            for i in range(j + 1):
                hij = dot(w, W[i]).to(f64) + beta_n * a * al[i]
                w = w - hij.to(w.dtype) * W[i]
                a = a - hij * al[i]
                hcol.append(hij)
            vals = self.syncs.values(*hcol, dot(w, w), a, fp, cp)
            H[:j + 1, j] = vals[:j + 1]
            wsq, a, fp, cp = vals[j + 1:]
            fproj.append(fp)
            cproj.append(cp)
            wnorm = float(np.sqrt(max(wsq + beta_n * a * a, 0.0)))
            H[j + 1, j] = wnorm
            if j + 1 < m and wnorm > 0.0:
                W.append(w / wnorm)
                al.append(a / wnorm)
            # Givens rotations maintaining the QR of H
            for i in range(j):
                t = cs[i] * H[i, j] + sn[i] * H[i + 1, j]
                H[i + 1, j] = -sn[i] * H[i, j] + cs[i] * H[i + 1, j]
                H[i, j] = t
            denom = np.hypot(H[j, j], H[j + 1, j])
            cs[j] = H[j, j] / denom if denom else 1.0
            sn[j] = H[j + 1, j] / denom if denom else 0.0
            H[j, j] = denom
            H[j + 1, j] = 0.0
            g_vec[j + 1] = -sn[j] * g_vec[j]
            g_vec[j] = cs[j] * g_vec[j]
            iters = j + 1
            res = abs(g_vec[j + 1])
            # projections of the current least-squares solution (`:6040-
            # 6056`); a zero diagonal (lucky breakdown) counts as exact
            yk = _back_substitute(H, g_vec, j + 1)
            fpr = float(yk @ np.asarray(fproj))
            cpr = float(yk @ np.asarray(cproj))
            if verbose:
                self._logger.write(
                    "      %4d %4d %7.1e %7.1e %8.1e %8.1e\n"
                    % (self.nhvec, j + 1, res, res / bnorm, fpr, cpr))
            is_descent = fpr < 0.0 or cpr <= descent_thresh
            if (is_descent and (res < rtol * bnorm or res < atol)) \
                    or wnorm == 0.0:
                break
        k = iters
        y = _back_substitute(H, g_vec, k)
        final_res = abs(g_vec[k])
        if not np.isfinite(final_res) or final_res > bnorm:
            return None, iters
        # p = K_B⁻¹ Σ yᵢ v̂ᵢ (one final preconditioner application)
        u_w = torch.zeros_like(b.x)
        for i in range(k):
            u_w = u_w + float(y[i]) * W[i]
        u_a = float(sum(y[i] * al[i] for i in range(k)))
        p = precon(embed(u_w, u_a))
        # the assembled step must itself be a descent direction
        # (`:6154-6189`), else the quasi-Newton step is taken
        fpr_f, cpr_f = self.syncs.values(
            *_nk_projections(v, d, b, p, mu_j, rbb))
        if verbose:
            self._logger.write("      %9s %7s %7s %8.1e %8.1e\n"
                               % ("final", " ", " ", fpr_f, cpr_f))
        if not (fpr_f < 0.0 or cpr_f < descent_thresh):
            return None, iters
        return p, iters

    # -- checkpointing (`writeSolutionFile`/`readSolutionFile`) -------------

    def _state_is_sharded(self) -> bool:
        """True when some state leaf is distributed over a device mesh."""
        return tree_is_sharded(self.vars)

    @spmd(probe=_own_state)
    def write_solution_file(self, path: str) -> None:
        """The primal-dual point and the barrier parameter as an npz file
        (paropt_tpu's format; ``np.savez`` adds ``.npz`` to a bare name).
        Each field is one counted read of the device.  Sharded state goes
        to a ``torch.distributed.checkpoint`` directory instead (each rank
        writes its shards, the role of the reference's MPI-IO collective
        write and of paropt_tpu's Orbax directory); every rank calls."""
        if self._state_is_sharded():
            from .utils.checkpoint import save_state
            save_state(path, {"vars": self.vars,
                              "mu": self._scalar(self.mu)})
            return
        arrays = {f.name: self.syncs.array(getattr(self.vars, f.name))
                  for f in dataclasses.fields(IPVars)}
        arrays["mu"] = np.asarray(self.mu)
        np.savez(path, **arrays)

    @spmd(probe=_own_state)
    def read_solution_file(self, path: str) -> None:
        """Resume from a file of `write_solution_file` (or paropt_tpu's):
        the point and μ are replaced; the QN approximation restarts, as in
        the reference.  A directory is a sharded checkpoint: each leaf is
        restored with the placements of the solver's current state."""
        if os.path.isdir(path):
            from .utils.checkpoint import restore_state
            got = restore_state(path, {"vars": self.vars,
                                       "mu": self._scalar(self.mu)})
            self.vars = got["vars"]
            self.mu = self.syncs.value(got["mu"])
            return
        if not path.endswith(".npz"):
            path = path + ".npz"
        with np.load(path) as dat:
            fields = {f.name: dat[f.name] for f in dataclasses.fields(IPVars)}
            mu = float(dat["mu"])
        for name, val in fields.items():
            want = tuple(getattr(self.vars, name).shape)
            if val.shape != want:
                raise ValueError(f"checkpoint field {name} has shape "
                                 f"{val.shape}, expected {want}")
        npdt = np.float64 if self.dtype == torch.float64 else np.float32
        self.vars = IPVars(**{name: self.syncs.upload(val.astype(npdt),
                                                      self.device)
                              for name, val in fields.items()})
        self.mu = mu

    # -- accessors -----------------------------------------------------------

    def get_optimized_point(self):
        v = self.vars
        return v.x, v.z, v.zw, v.zl, v.zu

    def get_optimized_slacks(self):
        """-> (s, t, sw, tw) (`getOptimizedSlacks`, ParOpt.pyx:1291-1310)."""
        v = self.vars
        return v.s, v.t, v.sw, v.tw

    def reset_quasi_newton_hessian(self):
        """Zero out the quasi-Newton approximation
        (`resetQuasiNewtonHessian`, ParOpt.pyx:1344-1345)."""
        self._reset_qn()

    def get_iteration_counters(self):
        return self.niter, self.neval, self.ngeval, self.nhvec

    def get_barrier_parameter(self):
        return self.mu

    def set_barrier_parameter(self, mu):
        self.mu = float(mu)

    @spmd(probe=_own_state)
    def get_complementarity(self):
        return self.syncs.value(
            kkt.average_complementarity(self.vars, self._make_data()))

    # -- the major iteration loop -------------------------------------------

    @spmd(probe=_own_state)
    def optimize(self, checkpoint: Optional[str] = None) -> Dict[str, Any]:
        """Run the optimization (`ParOptInteriorPoint::optimize`,
        `ParOptInteriorPoint.cpp:4399-5333`).  Returns a result dict.
        ``checkpoint``: a path that `write_solution_file` rewrites every
        ``write_output_frequency`` iterations (`:4620-4629`)."""
        o = self.options
        norm_type = o["norm_type"]
        abs_res_tol = o["abs_res_tol"]
        abs_step_tol = o["abs_step_tol"]
        rel_func_tol = o["rel_func_tol"]
        barrier_strategy = o["barrier_strategy"]
        max_iters = o["max_major_iters"]
        fprec = o["function_precision"]
        dprec = o["design_precision"]
        rbb = o["rel_bound_barrier"]
        refine_steps = o["iterative_refinement_steps"]
        seq_linear = o["sequential_linear_method"]
        use_line_search = o["use_line_search"]
        hessian_reset_freq = o["hessian_reset_freq"]
        write_freq = o["write_output_frequency"]
        output_file = o["output_file"]
        mpc_family = ("mehrotra", "mehrotra_predictor_corrector")
        summary = ""
        if output_file:
            # full option summary at the log header (printOptionSummary,
            # ParOptInteriorPoint.cpp:869-881)
            lines = ["options:"]
            for name in o:
                lines.append(f"  {name} = {o[name]!r}")
            summary = "\n".join(lines) + "\n"
        self._logger = IPLogger(output_file, options_summary=summary)
        use_qn_default = (self.qn is not None and not seq_linear)
        read = self.syncs.values

        # initial evaluation (failure aborts, ParOptInteriorPoint.cpp:4549)
        self.fobj, self.c, self.cw = self._eval_obj_con(self.vars.x)
        if self.fobj is None:
            raise RuntimeError("initial objective evaluation failed")
        self.g, self.A = self._eval_gradients(self.vars.x)
        d = self._make_data()

        # multiplier initialization strategy
        strategy = o["starting_point_strategy"]
        if strategy == "affine_step":
            self._init_affine_step_multipliers(d)
        elif strategy == "least_squares_multipliers":
            self._init_least_squares_multipliers(d)

        fobj_prev = self.syncs.value(self.fobj)
        res_norm = float("inf")
        res_norm_prev = None
        step_norm_prev = None
        alpha_prev = alpha_xprev = alpha_zprev = 1.0
        dm0_prev = 0.0
        line_search_test = 0
        no_merit_improvement = False
        self._converged_reason = ""
        converged = False
        info_prev = ""

        def step(compact, use_qn, mu_j, refine=refine_steps):
            return _compute_step(self.vars, d, compact, mu_j, rbb,
                                 o["qn_sigma"], refine, use_qn,
                                 self._csr_mat)

        def scale_and_merit(p, mu_j, comp_j, compact):
            """The DQN/SLP rungs' rescaled step and merit (no QN term)."""
            p_s, ax, az, ceq = _scale_step(self.vars, d, p, mu_j, comp_j,
                                           o["min_fraction_to_boundary"])
            mp = _merit_parts(self.vars, d, p_s, self.fobj, mu_j, rbb,
                              compact, False)
            vals = read(ax, az, *mp)
            return p_s, vals[0], vals[1], ceq, vals[2:]

        k = 0
        for k in range(max_iters):
            self.niter = k
            info = info_prev
            qn_hessian_reset = False
            # QN-update outcome flags: re-initialized every major iteration
            # (_accept_step may never run), so stale flags never leak into
            # this iteration's info row
            skipped = damped = 0
            if (self.qn is not None and not seq_linear and k > 0
                    and k % hessian_reset_freq == 0
                    and o["use_quasi_newton_update"]):
                self._reset_qn()
                qn_hessian_reset = True

            if write_freq > 0 and k % write_freq == 0:
                if checkpoint:
                    try:
                        self.write_solution_file(checkpoint)
                    except OSError:
                        checkpoint = None
                self.problem.write_output(k, self.vars.x)

            gv_freq = o["gradient_verification_frequency"]
            if k > 0 and gv_freq > 0 and k % gv_freq == 0:
                self.problem.check_gradients(
                    o["gradient_check_step_length"], x=self.vars.x,
                    check_hvec_product=o["use_hvec_product"])

            # barrier strategy (ParOptInteriorPoint.cpp:4656-4764); the
            # objective is read with the residual norms
            mu_j = self._scalar(self.mu)
            norms = _residual_and_norms(self.vars, d, mu_j, rbb, norm_type)
            fobj_k, prime, dual, infeas_n, res_norm, comp = read(self.fobj,
                                                                 *norms)
            comp_j = norms[4]
            # convergence bookkeeping tests
            rel_function_test = (
                alpha_xprev == 1.0 and alpha_zprev == 1.0
                and abs(fobj_k - fobj_prev)
                < rel_func_tol * abs(fobj_prev) if k > 0 else False)
            if no_merit_improvement:
                line_search_test += 1
            else:
                line_search_test = 0
            if res_norm_prev is None:
                res_norm_prev = res_norm

            renorm = False
            if barrier_strategy == "monotone":
                barrier_converged = k > 0 and (
                    res_norm < 10.0 * self.mu or rel_function_test
                    or line_search_test >= 2)
                if barrier_converged:
                    if self.mu > 0.1 * abs_res_tol:
                        line_search_test = 0
                    frac = o["monotone_barrier_fraction"] * self.mu
                    powv = self.mu ** o["monotone_barrier_power"]
                    new_mu = min(frac, powv)
                    if new_mu < 0.1 * abs_res_tol:
                        new_mu = 0.09999 * abs_res_tol
                    self.mu = new_mu
                    self.rho_penalty = o["min_rho_penalty_search"]
                    renorm = True
            elif barrier_strategy == "complementarity_fraction":
                self.mu = max(o["monotone_barrier_fraction"] * comp,
                              0.1 * abs_res_tol)
                renorm = True
            # mehrotra / mpc adapt μ after the affine probe below
            if renorm:
                mu_j = self._scalar(self.mu)
                norms = _residual_and_norms(self.vars, d, mu_j, rbb,
                                            norm_type)
                prime, dual, infeas_n, res_norm, comp = read(*norms)
                comp_j = norms[4]

            if (self._csr_mat is not None
                    and (o["output_level"] > 0 or k == 0)):
                # the factor's fill-in ('MatInfo:' rows,
                # ParOptInteriorPoint.cpp:4768-4775)
                self._logger.write(
                    f"MatInfo: {self._csr_mat.get_factor_info()}\n")
            self._logger.log(k, self.neval, self.ngeval, self.nhvec,
                             alpha_prev, alpha_xprev, alpha_zprev,
                             fobj_k, prime, infeas_n, dual,
                             self.mu, comp, dm0_prev, self.rho_penalty,
                             info, o["output_level"])
            info = ""

            # convergence (ParOptInteriorPoint.cpp:4811-4840); the step-norm
            # test only participates when abs_step_tol is set (default 0)
            step_test = (abs_step_tol > 0.0 and step_norm_prev is not None
                         and step_norm_prev < abs_step_tol)
            if k > 0 and self.mu <= 0.1 * abs_res_tol and (
                    res_norm < abs_res_tol or rel_function_test
                    or line_search_test >= 2 or step_test):
                if rel_function_test:
                    self._converged_reason = "rel_function"
                elif line_search_test >= 2:
                    self._converged_reason = "no_improvement"
                elif step_test:
                    self._converged_reason = "step_tol"
                else:
                    self._converged_reason = "tolerance"
                converged = True
                break

            # -- step computation ------------------------------------------
            fobj_before_step = fobj_k
            # Newton-Krylov inexact phase (`ParOptInteriorPoint.cpp:
            # 4853-4899`): once all residuals drop below nk_switch_tol and
            # the Eisenstat-Walker forcing term is small enough, solve the
            # exact KKT linearization by preconditioned GMRES
            inexact_step = None
            if (o["use_hvec_product"] and o["gmres_subspace_size"] > 0
                    and res_norm_prev is not None and res_norm_prev > 0):
                gmres_rtol = (o["eisenstat_walker_gamma"]
                              * (res_norm / res_norm_prev)
                              ** o["eisenstat_walker_alpha"])
                nk_tol = o["nk_switch_tol"]
                if (prime < nk_tol and dual < nk_tol and infeas_n < nk_tol
                        and gmres_rtol < o["max_gmres_rtol"]):
                    inexact_step, gmres_iters = self._gmres_step(
                        d, mu_j, self._qn_compact(), max(gmres_rtol, 1e-12))
                    if inexact_step is not None:
                        info += f"iNK{gmres_iters} "
                    elif gmres_iters > 0 and o["output_level"] > 0:
                        # a rejected non-descent NK step
                        # (`ParOptInteriorPoint.cpp:4885-4888`)
                        self._logger.write("      %9s\n" % "step failed")
            if o["use_diag_hessian"]:
                # B = diag(h) from the problem's Hessian diagonal (the MMA
                # subproblem path, `ParOptInteriorPoint.cpp:4944-4949`)
                hd = self._tensor(self.problem.eval_hessian_diag(
                    self.vars.x, self.vars.z, self.vars.zw))
                self.nhvec += 1
                if not self.syncs(torch.all(torch.isfinite(hd))):
                    raise RuntimeError("Hessian diagonal evaluation failed")
                compact = (hd, None, None)
                use_qn = True
            else:
                compact = self._qn_compact()
                use_qn = use_qn_default
            sv_freq = o["step_verification_frequency"]
            sv_check_iter = sv_freq > 0 and k % sv_freq == 0
            if inexact_step is not None:
                p = inexact_step
            elif barrier_strategy in mpc_family:
                # affine probe: step toward μ = 0 from the same
                # factorization
                p_aff = step(compact, use_qn, self._scalar(0.0), refine=0)
                ax_a, az_a = read(*kkt.max_step_lengths(
                    self.vars, d, p_aff, self._scalar(1.0)))
                v_aff = self.vars.axpy(ax_a, az_a, p_aff)
                comp_aff = self.syncs.value(
                    kkt.average_complementarity(v_aff, d))
                sigma = max((comp_aff / comp) ** 3 if comp > 0 else 0.01,
                            0.01)
                self.mu = max(sigma * comp, 0.09999 * abs_res_tol)
                mu_j = self._scalar(self.mu)
                if (barrier_strategy == "mehrotra_predictor_corrector"
                        and not self._eager):
                    p_aff_s = p_aff.scaled(min(ax_a, 1.0), min(az_a, 1.0))
                    p = _compute_step_mpc(self.vars, d, compact, mu_j, rbb,
                                          o["qn_sigma"], p_aff_s,
                                          refine_steps, use_qn)
                else:
                    p = step(compact, use_qn, mu_j)
            else:
                p = step(compact, use_qn, mu_j)

            res_norm_prev = max(res_norm, 1e-30)
            if (sv_check_iter and inexact_step is None
                    and barrier_strategy not in mpc_family):
                err = self.syncs.value(_check_kkt_step(
                    self.vars, d, p, compact, mu_j, rbb, o["qn_sigma"],
                    use_qn))
                self._logger.write(
                    f"KKT step check: max |K*p + r| = {err:.6e}\n")

            # fraction-to-boundary scaling (equal steps: Newton steps) and
            # the merit parts, read with the unscaled step norm in one go
            p_s, axj, azj, ceq = _scale_step(
                self.vars, d, p, mu_j, comp_j, o["min_fraction_to_boundary"],
                inexact=inexact_step is not None)
            mp_t = _merit_parts(self.vars, d, p_s, self.fobj, mu_j, rbb,
                                compact, use_qn)
            pxn = [norm(p.x, norm_type)] if abs_step_tol > 0.0 else []
            head = read(axj, azj, ceq.to(axj.dtype), *mp_t, *pxn)
            ax, az, ceq_b, mp = head[0], head[1], head[2] != 0, head[3:8]
            if abs_step_tol > 0.0:
                step_norm_prev = head[8]
            if ceq_b:
                info += "cmpEq "

            line_fail = LS_FAILURE
            alpha = 1.0
            no_merit_improvement = False

            if use_line_search:
                m0, dm0 = self._rho_update(*mp, ax)
                dm0_prev = dm0
                # FD-verify the merit derivative along the ACTUAL step
                # (`ParOptInteriorPoint.cpp:5177-5180`); the check runs a
                # ρ update of its own, so the penalty is restored after it
                if gv_freq > 0 and k % gv_freq == 0:
                    rho_saved = self.rho_penalty
                    try:
                        self.check_merit_func_gradient(
                            None, o["gradient_check_step_length"], p=p_s)
                    finally:
                        self.rho_penalty = rho_saved
                if 0.0 <= dm0 <= fprec:
                    # descent within precision of zero: skip the line search
                    ok, skipped, damped = self._accept_step(d, 1.0, p_s, None)
                    if not ok:
                        raise RuntimeError("function evaluation failed")
                    line_fail = LS_SUCCESS
                    if abs(self.syncs.value(self.fobj)
                           - fobj_before_step) <= fprec:
                        line_fail |= LS_NO_IMPROVEMENT
                    info += "skipLS "
                else:
                    if dm0 >= 0.0:
                        # not a descent direction: reset QN, diagonal-only
                        # step (ParOptInteriorPoint.cpp:5130-5173)
                        if self.qn is not None:
                            self._reset_qn()
                            qn_hessian_reset = True
                        compact = self._qn_compact()
                        p = step(compact, False, mu_j)
                        p_s, ax, az, ceq, mp = scale_and_merit(p, mu_j,
                                                               comp_j,
                                                               compact)
                        m0, dm0 = self._rho_update(*mp, ax)
                        dm0_prev = dm0
                        info += "DQN "
                    if dm0 >= 0.0 and not o["sequential_linear_method"]:
                        # last ladder stage (`ParOptInteriorPoint.cpp:
                        # 5264-5269`): drop the Hessian entirely, a
                        # sequential-linear step regularized only by the
                        # bound terms
                        compact = (self._scalar(0.0), None, None)
                        p = step(compact, False, mu_j)
                        p_s, ax, az, ceq, mp = scale_and_merit(p, mu_j,
                                                               comp_j,
                                                               compact)
                        m0, dm0 = self._rho_update(*mp, ax)
                        dm0_prev = dm0
                        info += "SLP "
                    if dm0 >= 0.0:
                        line_fail = LS_FAILURE
                        info += "LFail "
                    else:
                        px_norm = self.syncs.value(torch.max(torch.abs(
                            p_s.x)))
                        alpha_min = 1.0
                        if px_norm != 0.0:
                            alpha_min = min(fprec / px_norm, 0.5)
                        line_fail, alpha, trial = self._line_search(
                            d, p_s, alpha_min, m0, dm0)
                        if px_norm < dprec:
                            line_fail |= LS_SHORT_STEP
                        if not (line_fail & LS_FAILURE):
                            ok, skipped, damped = self._accept_step(
                                d, alpha, p_s, trial)
                            if not ok:
                                line_fail |= LS_FAILURE
                        if line_fail & LS_MIN_STEP:
                            info += "LMnStp "
                        if line_fail & LS_MAX_ITERS:
                            info += "LMxItr "
            else:
                m0, dm0 = self._rho_update(*mp, ax)
                dm0_prev = dm0
                ok, skipped, damped = self._accept_step(d, 1.0, p_s, None)
                if not ok:
                    raise RuntimeError("function evaluation failed")
                line_fail = LS_SUCCESS
                m1 = self.syncs.value(_merit_eval(
                    self.vars.x, self.vars.s, self.vars.t, self.vars.sw,
                    self.vars.tw, self.fobj, self.c, self.cw, d, mu_j, rbb,
                    self._scalar(self.rho_penalty)))
                if m0 - fprec <= m1 <= m0 + fprec:
                    line_fail |= LS_NO_IMPROVEMENT
                elif abs(dm0) <= fprec:
                    line_fail = LS_NO_IMPROVEMENT

            # quasi-Newton update outcome flags (the reference's skipH /
            # dampH vocabulary, `ParOptInteriorPoint.cpp:5272-5322`)
            if skipped:
                info += "skipH "
            if damped:
                info += "dampH "
            if line_fail & LS_NO_IMPROVEMENT:
                info += "LNoImprv "
            no_merit_improvement = bool(
                line_fail & (LS_NO_IMPROVEMENT | LS_MIN_STEP | LS_SHORT_STEP
                             | LS_FAILURE))
            if line_fail & LS_FAILURE:
                if self.qn is not None and o["use_quasi_newton_update"]:
                    self._reset_qn()
                info += "resetH "
            if qn_hessian_reset:
                info += "rstH "

            fobj_prev = fobj_before_step
            alpha_prev, alpha_xprev, alpha_zprev = alpha, ax, az
            info_prev = info

            # refresh the problem data with the new evaluations
            d = self._make_data()

        self.niter = k
        result = {
            "x": self.vars.x, "fobj": self.syncs.value(self.fobj),
            "converged": converged, "reason": self._converged_reason,
            "niter": k, "neval": self.neval, "ngeval": self.ngeval,
            "res_norm": res_norm, "mu": self.mu,
        }
        if converged:
            self._logger.write(
                "\nParOpt: Successfully converged to requested tolerance\n"
                if self._converged_reason == "tolerance" else
                "\nParOpt: Converged ({})\n".format(self._converged_reason))
        self._logger.close()
        return result
