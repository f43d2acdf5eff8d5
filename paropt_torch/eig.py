"""The compact eigenvalue-constraint approximation (counterpart of
paropt_tpu/eig.py, where the method is documented): one dense constraint
modeled by a low-rank quadratic

    c_index(xk + s)  ≈  c0 + g0·s + 1/2 sᵀ (hᵀ M h) s         (h: [N, n])

refreshed by a user callback at each accepted trust-region step, and the
Hessian of the inner interior point merging the objective quasi-Newton
approximation with the z0-scaled constraint curvature into one compact form
(`ParOptEigenQuasiNewton::getCompactMat`):

    B = b0·I − [Z_qn; h]ᵀ blockdiag(M_qn, M⁻¹/z0)⁻¹ [Z_qn; h]

`EigenSubproblem` runs through the host `TrustRegion(subproblem=...)`
(or `Optimizer.set_trust_region_subproblem`), whose inner solves are the
host `InteriorPoint`; `EigenQuasiNewton` sits in the QN holder where a
`QNState` usually sits and is read through ``compact()``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from .dtypes import resolve_device, resolve_dtype
from .ops import qn as qnmod
from .tr import QuadraticSubproblem, _with_row

__all__ = ["CompactEigenApprox", "EigenQuasiNewton", "EigenSubproblem"]


class CompactEigenApprox:
    """Low-rank quadratic model of one constraint
    (`ParOptCompactEigenApprox`, `ParOptCompactEigenvalueApprox.h:7-32`)."""

    def __init__(self, nvars: int, N: int, dtype=None, device=None):
        kw = dict(dtype=resolve_dtype(dtype), device=resolve_device(device))
        self.nvars = nvars
        self.N = N
        self.c0 = torch.zeros((), **kw)
        self.g0 = torch.zeros(nvars, **kw)
        self.M = torch.eye(N, **kw)
        self.Minv = torch.eye(N, **kw)
        self.hvecs = torch.zeros((N, nvars), **kw)

    def _as(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=self.hvecs.dtype,
                               device=self.hvecs.device)

    def set_approximation(self, c0=None, g0=None, M=None, hvecs=None,
                          Minv=None):
        """``setApproximationValues(c0, M, Minv)``
        (`ParOptCompactEigenvalueApprox.cpp:118-133`).  KS curvature
        matrices are singular (rank N−1), so the reference takes the inverse
        explicitly; without ``Minv`` it is the pseudo-inverse of M."""
        if c0 is not None:
            self.c0 = self._as(c0)
        if g0 is not None:
            self.g0 = self._as(g0)
        if M is not None:
            self.M = self._as(M)
            self.Minv = (self._as(Minv) if Minv is not None
                         else torch.linalg.pinv(self.M))
        elif Minv is not None:
            self.Minv = self._as(Minv)
        if hvecs is not None:
            self.hvecs = self._as(hvecs)

    def eval_approximation(self, s=None):
        if s is None:
            return self.c0
        hs = self.hvecs @ s
        return self.c0 + torch.dot(self.g0, s) + 0.5 * torch.dot(
            hs, self.M @ hs)

    def eval_approximation_gradient(self, s):
        return self.g0 + self.hvecs.T @ (self.M @ (self.hvecs @ s))

    def mult_add(self, alpha, x):
        """alpha · H x with H = hᵀ M h (`multAdd`)."""
        return alpha * (self.hvecs.T @ (self.M @ (self.hvecs @ x)))


class EigenQuasiNewton:
    """The merged Hessian approximation B_qn − z0·H_eig as one compact form
    (`ParOptEigenQuasiNewton`, `ParOptCompactEigenvalueApprox.h:34-84`).
    It offers the surface the interior point reads from a QN holder:
    ``compact()``, ``mult()``, ``reset()``, ``update_multipliers()``."""

    def __init__(self, qn_state: Optional[qnmod.QNState],
                 eigh: CompactEigenApprox, index: int = 0):
        self.qn = qn_state
        self.eigh = eigh
        self.index = index
        self.z0 = torch.ones((), dtype=eigh.hvecs.dtype,
                             device=eigh.hvecs.device)
        self.use_quasi_newton_objective = True
        self.scaled = False  # the QNState attribute the IP reads

    def update_multipliers(self, x, z, zw):
        """``update(x, z, zw)``: z0 = z[index]
        (`ParOptCompactEigenvalueApprox.cpp:183`)."""
        self.z0 = torch.as_tensor(z[self.index], dtype=self.z0.dtype,
                                  device=self.z0.device)

    def update(self, x, z, zw, s, y, syncs=None):
        """The (s, y) pair goes to the objective QN and z0 is refreshed;
        returns (skipped, damped) as ints, read through ``syncs`` (a
        `HostSyncs`) when given."""
        self.update_multipliers(x, z, zw)
        if self.qn is None:
            return 0, 0
        self.qn, skipped, damped = qnmod.qn_update(self.qn, s, y)
        if syncs is not None:
            skipped, damped = syncs.values(skipped, damped)
        return int(skipped), int(damped)

    def reset(self):
        if self.qn is not None:
            self.qn = qnmod.qn_reset(self.qn)

    def compact(self):
        """(b0, Z, M) with B = b0 I − Zᵀ M⁻¹ Z (`getCompactMat`, with the
        reference's z0 → 0 convention: z0 = 0 scales by 1)."""
        eigh = self.eigh
        dtype = eigh.hvecs.dtype
        nz = self.z0 != 0.0
        z0inv = torch.where(nz, 1.0 / torch.where(nz, self.z0, 1.0), 1.0)
        Me = z0inv * eigh.Minv
        if self.qn is not None and self.use_quasi_newton_objective:
            b0, Zq, Mq = qnmod.qn_compact(self.qn)
            Z = torch.cat([Zq.to(dtype), eigh.hvecs], dim=0)
            return b0, Z, torch.block_diag(Mq.to(dtype), Me)
        return torch.zeros((), dtype=dtype, device=Me.device), eigh.hvecs, Me

    def mult(self, x):
        b0, Z, M = self.compact()
        return b0 * x - Z.T @ torch.linalg.solve(M, Z @ x)


class EigenSubproblem(QuadraticSubproblem):
    """The TR subproblem whose constraint ``index`` uses the low-rank
    quadratic eigenvalue model, refreshed by a user callback at each
    accepted step (`ParOptEigenSubproblem`,
    `ParOptCompactEigenvalueApprox.h:86-204`).

    The callback has the signature ``update(x, eigh)`` and may call
    ``eigh.set_approximation(...)``; on entry c0 and g0 hold the real
    constraint value and gradient at the new point."""

    def __init__(self, problem, eigen_qn: EigenQuasiNewton):
        holder: Dict[str, Any] = {"state": eigen_qn}
        super().__init__(problem, holder)
        self.approx = eigen_qn
        self._update_fn: Optional[Callable] = None

    def set_eigen_model_update(self, fn: Callable) -> None:
        self._update_fn = fn

    # the objective model is quadratic with the MERGED Hessian
    # (B_qn − z0 H); the eigen row is the low-rank quadratic model
    def model_obj_con(self, p=None):
        eigh, idx = self.approx.eigh, self.approx.index
        if p is None:
            c = (_with_row(self.ck, idx, eigh.eval_approximation(None))
                 if self.ncon else self.ck)
            return self.fk, c
        f = self.fk + torch.dot(self.gk, p) + 0.5 * torch.dot(
            p, self.approx.mult(p))
        c = self.ck + self.Ak @ p if self.ncon else self.ck
        return f, _with_row(c, idx, eigh.eval_approximation(p))

    def eval_obj_con(self, p):
        return self.model_obj_con(p)

    def eval_obj_con_gradient(self, p):
        g = self.gk + self.approx.mult(p)
        A = _with_row(self.Ak, self.approx.index,
                      self.approx.eigh.eval_approximation_gradient(p))
        return g, A

    def eval_trial_step_and_update(self, update_flag, p, z, zw):
        """The real evaluation only; the QN and model updates wait for the
        accept (`ParOptEigenSubproblem::evalTrialStepAndUpdate`)."""
        xt = self.xk + p
        ft, ct = self.prob.eval_obj_con(xt)
        self.ft = self._as(ft)
        self.ct = self._as(ct).reshape(self.ncon)
        self.gt, self.At = self.prob.eval_obj_con_gradient(xt)
        self.qn_update_type = (0, 0)
        return self.ft, self.ct

    def accept_trial_step(self, p, z=None, zw=None):
        """Refresh the eigen model through the callback and update the
        objective QN (`ParOptEigenSubproblem::acceptTrialStep`)."""
        xt = self.xk + p
        idx = self.approx.index
        eigh = self.approx.eigh
        # the linear terms default to the real evaluation's
        eigh.set_approximation(c0=self.ct[idx], g0=self.At[idx])
        if self._update_fn is not None:
            self._update_fn(xt, eigh)
        if z is not None and self.approx.qn is not None:
            y0 = self._lagrangian_gradient(self.gk, self.Ak, self.xk, z, zw)
            y = self._lagrangian_gradient(self.gt, self.At, xt, z, zw) - y0
            s, y = self.prob.compute_quasi_newton_update_correction(
                xt, z, zw, p, y)
            self.qn_update_type = self.approx.update(xt, z, zw, s, y,
                                                     syncs=self.syncs)
        self.xk = xt
        self.fk, self.ck, self.gk, self.Ak = self.ft, self.ct, self.gt, \
            self.At
        self._linearize()
