"""Method of Moving Asymptotes: the host-loop `MMA` and the fused outer loop
`FusedMMA` (counterpart of paropt_tpu/mma.py, where the method is
documented).

Each outer iteration evaluates the problem, updates the asymptotes
(contract/relax rule), the move limits, the inner bounds α/β and the p/q
coefficients of the separable convex approximation, tests the KKT error, and
solves the approximation with the fused interior-point solver (diagonal
Hessian, no line search).  `MMA` makes these decisions on the host, as the
JAX package's does, and is itself the subproblem `Problem`; ``MMA.syncs``
counts its host reads.  `FusedMMA` keeps the outer iteration on the device:
the JAX package runs the whole loop as one ``lax.while_loop``; here it is a
host loop over outer iterations, and the inner solve is skipped after one
host read of ``converged`` once the loop has converged (JAX's
``lax.cond``).  ``FusedMMA.syncs`` counts the host reads, the inner
solver's included.  `FusedMMA.solve_batched` runs k multi-start solves as
one: the outer step's phases (`_mma_head`, the inner solve, `_mma_tail`)
under ``torch.func.vmap``.
"""

from __future__ import annotations

import dataclasses
import functools
import weakref
from collections import OrderedDict
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from .ip import HostSyncs, InteriorPoint
from .ip_fused import (FusedIP, FusedIPOptions, ModelFns, _fused_init,
                       _fused_solve_loop, _Run)
from .ops.kkt import ProblemData
from .parallel.sharding import spmd
from .problem import Problem
from .tr import _viol
from .tree import pytree, tmap
from .utils.logging import MMALogger
from .utils.options import OptionRegistry, make_options
from .utils.spans import span, spanned

__all__ = ["MMA", "MMAParams", "make_mma_model", "FusedMMA",
           "fused_mma_solve", "FusedMMAOptions", "FusedMMAState"]


class MMAParams(NamedTuple):
    """Data of the separable MMA subproblem model."""
    L: Any
    U: Any
    p0: Any
    q0: Any
    pi: Any
    qi: Any
    b: Any
    cons: Any
    A: Any
    x0: Any
    cwk: Any
    Aw_cols: Any
    Aw_vals: Any


def make_mma_model(use_true_mma: bool, has_sparse: bool) -> ModelFns:
    """Fused-IP model functions for the MMA subproblem
    (`ParOptMMA::evalObjCon/evalObjConGradient/evalHessianDiag`,
    `ParOptMMA.cpp:804-1010`)."""

    def ev(p: MMAParams, x):
        Uinv = 1.0 / (p.U - x)
        Linv = 1.0 / (x - p.L)
        f = torch.sum(p.p0 * Uinv + p.q0 * Linv)
        if p.cons.shape[0] == 0:
            c = p.cons
        elif use_true_mma:
            c = -(p.pi @ Uinv + p.qi @ Linv + p.b)
        else:
            c = p.cons + p.A @ (x - p.x0)
        if has_sparse:
            gathered = (x - p.x0)[..., p.Aw_cols]
            cw = p.cwk + torch.sum(p.Aw_vals * gathered, dim=-1)
        else:
            cw = p.cwk
        return f, c, cw

    def gr(p: MMAParams, x):
        Uinv = 1.0 / (p.U - x)
        Linv = 1.0 / (x - p.L)
        g = p.p0 * Uinv ** 2 - p.q0 * Linv ** 2
        if p.cons.shape[0] > 0 and use_true_mma:
            A = p.qi * (Linv ** 2)[None, :] - p.pi * (Uinv ** 2)[None, :]
        else:
            A = p.A
        return g, A

    def hd(p: MMAParams, x, z, zw):
        Uinv = 1.0 / (p.U - x)
        Linv = 1.0 / (x - p.L)
        h = 2.0 * (p.p0 * Uinv ** 3 + p.q0 * Linv ** 3)
        if use_true_mma and p.cons.shape[0] > 0:
            h = h + 2.0 * (z @ (p.pi * (Uinv ** 3)[None, :]
                                + p.qi * (Linv ** 3)[None, :]))
        return h

    return ModelFns(eval_obj_con=ev, eval_grad=gr, hess_diag=hd)


class MMA(Problem):
    """MMA outer loop (`ParOptMMA`), on the device of the problem's x0; also
    the separable subproblem, as a `Problem` over x.  Each outer iteration
    re-linearizes about the new point, updates the asymptotes and the p/q
    coefficients on the host's schedule, and solves the approximation with
    a `FusedIP` (diagonal Hessian, no line search).  ``syncs`` counts the
    host reads, the inner solves' included; ``mma_output_file`` None
    writes no log."""

    def __init__(self, problem: Problem, options: Optional[Any] = None):
        super().__init__(nvars=problem.nvars, ncon=problem.ncon,
                         nwcon=problem.nwcon, nwblock=problem.nwblock,
                         ninequality=problem.ninequality,
                         nwinequality=problem.nwinequality)
        self.prob = problem
        if isinstance(options, OptionRegistry):
            self.options = options
        else:
            self.options = make_options(options, which="facade")
        o = self.options
        self.use_true_mma = not o["mma_use_constraint_linearization"]
        self.syncs = HostSyncs()

        self.x, self.lbv, self.ubv = problem.get_vars_and_bounds()
        self.x1 = self.x
        self.x2 = self.x
        n = self.nvars
        kw = dict(dtype=self.x.dtype, device=self.x.device)
        self.L = torch.zeros(n, **kw)
        self.U = torch.zeros(n, **kw)
        self.alpha = torch.zeros(n, **kw)
        self.beta = torch.zeros(n, **kw)
        self.p0 = torch.zeros(n, **kw)
        self.q0 = torch.zeros(n, **kw)
        self.pi = torch.zeros((self.ncon, n), **kw)
        self.qi = torch.zeros((self.ncon, n), **kw)
        self.b = torch.zeros(self.ncon, **kw)
        self.fobj = self.cons = self.cw = self.g = self.A = None
        self.z = torch.zeros(self.ncon, **kw)
        self.zw = torch.zeros(self.nwcon, **kw)
        self.zl = torch.zeros(n, **kw)
        self.zu = torch.zeros(n, **kw)
        self.mma_iter = 0
        self.subproblem_iter = 0

        # the interior-point solver over this subproblem with the forced
        # options (`ParOptMMA.cpp:342-344`), as in the reference's API; the
        # outer loop's solves run the fused solver built below
        ip_opts = self.options.copy()
        ip_opts["use_diag_hessian"] = True
        ip_opts["use_line_search"] = False
        ip_opts["qn_type"] = "none"
        ip_opts["write_output_frequency"] = 0
        ip_opts["output_file"] = None
        self.ip = InteriorPoint(self, ip_opts)
        self.ip.syncs = self.syncs
        self._logger = None
        self._fused: Optional[FusedIP] = None

    def _build_fused(self):
        o = self.options
        fopts = FusedIPOptions(
            abs_res_tol=o["abs_res_tol"],
            init_barrier_param=o["init_barrier_param"],
            monotone_barrier_fraction=o["monotone_barrier_fraction"],
            monotone_barrier_power=o["monotone_barrier_power"],
            rel_bound_barrier=o["rel_bound_barrier"],
            min_fraction_to_boundary=o["min_fraction_to_boundary"],
            function_precision=o["function_precision"],
            design_precision=o["design_precision"],
            max_major_iters=o["max_major_iters"],
            iterative_refinement_steps=o["iterative_refinement_steps"],
            barrier_strategy=o["barrier_strategy"],
            starting_point_strategy=o["starting_point_strategy"],
            use_line_search=False,
            use_diag_hessian=True,
            norm_type=o["norm_type"])
        model = make_mma_model(self.use_true_mma, self.nwcon > 0)
        self._fused = FusedIP(model, self.nvars, self.ncon, self.nwcon,
                              self.nwblock, fopts, dtype=self.ip.dtype)
        self._fused.syncs = self.syncs

    def _solve_subproblem_fused(self):
        """One inner IP solve of the current MMA approximation."""
        if self._fused is None:
            self._build_fused()
        kw = dict(dtype=self.ip.dtype, device=self.x.device)
        n, ncon, nwcon = self.nvars, self.ncon, self.nwcon
        if nwcon > 0:
            Aw = self.prob.sparse_jacobian(self.x)
            cols, vals, layout = Aw.cols, Aw.vals.to(**kw), Aw.layout
            cwk = self.cw.to(**kw)
        else:
            cols = vals = None
            cwk = torch.zeros(0, **kw)
            layout = "gather"
        params = MMAParams(
            L=self.L.to(**kw), U=self.U.to(**kw), p0=self.p0.to(**kw),
            q0=self.q0.to(**kw), pi=self.pi.to(**kw), qi=self.qi.to(**kw),
            b=self.b.to(**kw), cons=self.cons.to(**kw), A=self.A.to(**kw),
            x0=self.x.to(**kw), cwk=cwk, Aw_cols=cols, Aw_vals=vals)
        gamma = self.options["penalty_gamma"]
        ones = torch.ones(n, **kw)
        data = ProblemData(
            g=torch.zeros(n, **kw), A=torch.zeros((ncon, n), **kw),
            c=torch.zeros(ncon, **kw), cw=torch.zeros(nwcon, **kw),
            lb=self.alpha.to(**kw), ub=self.beta.to(**kw),
            lb_mask=ones, ub_mask=ones,
            gamma_s=torch.as_tensor(
                np.where(np.arange(ncon) < self.ninequality, 0.0, gamma),
                **kw),
            gamma_t=torch.full((ncon,), gamma, **kw),
            gamma_sw=torch.as_tensor(
                np.where(np.arange(nwcon) < self.nwinequality, 0.0, gamma),
                **kw),
            gamma_tw=torch.full((nwcon,), gamma, **kw),
            Aw_cols=cols, Aw_vals=vals, nwblock=self.nwblock,
            Aw_layout=layout)
        st = self._fused.solve(self.x.to(**kw), data, params)
        self.subproblem_iter += int(self.syncs.value(st.k))
        return st.vars.x, st.vars.z, st.vars.zw, st.vars.zl, st.vars.zu

    # ------------------------------------------------------------------
    # outer loop
    # ------------------------------------------------------------------

    def optimize(self) -> Dict[str, Any]:
        """`ParOptMMA::optimize` (`ParOptMMA.cpp:318-379`)."""
        o = self.options
        infeas_tol = o["mma_infeas_tol"]
        l1_tol = o["mma_l1_tol"]
        linf_tol = o["mma_linfty_tol"]
        self._logger = MMALogger(o["mma_output_file"])
        scaling = o["mma_kkt_error_scaling"]
        max_no_improve = o["mma_max_no_improvement"]

        self.initialize_subproblem(self.x)
        converged = stalled = False
        infeas = l1 = linf = float("inf")
        best_l1 = float("inf")
        no_improve = 0
        for _ in range(o["mma_max_iterations"]):
            x, z, zw, zl, zu = self._solve_subproblem_fused()
            # set multipliers + re-linearize about the new point
            self.z, self.zw, self.zl, self.zu = z, zw, zl, zu
            self.initialize_subproblem(x)
            infeas, l1, linf = self.compute_kkt_error()
            # 'gradient' scaling: relative stationarity
            s1 = sinf = 1.0
            if scaling == "gradient":
                g_l1, g_inf = self.syncs.values(
                    torch.sum(torch.abs(self.g)),
                    torch.max(torch.abs(self.g)))
                s1, sinf = max(1.0, g_l1), max(1.0, g_inf)
            if infeas < infeas_tol and (l1 < l1_tol * s1
                                        or linf < linf_tol * sinf):
                converged = True
                break
            # no-improvement window (mma_max_no_improvement): stop at the
            # arithmetic-noise stationarity floor
            if l1 < best_l1:
                best_l1, no_improve = l1, 0
            else:
                no_improve += 1
            if (max_no_improve > 0 and no_improve >= max_no_improve
                    and infeas < infeas_tol):
                converged = stalled = True
                break
        self._logger.close()
        return {"x": self.x, "fobj": self.syncs.value(self.fobj),
                "converged": converged, "stalled": stalled,
                "niter": self.mma_iter,
                "infeas": infeas, "l1": l1, "linfty": linf}

    def get_optimized_point(self):
        return self.x

    def get_asymptotes(self):
        """-> (L, U) current moving asymptotes (`getAsymptotes`,
        ParOpt.pyx:1383-1388)."""
        return self.L, self.U

    def get_design_history(self):
        """-> (x1, x2), the two previous design iterates
        (`getDesignHistory`, ParOpt.pyx:1389-1394)."""
        return self.x1, self.x2

    def initialize_subproblem(self, xv):
        """Shift history, evaluate f/c/gradients at the new point, update
        asymptotes and p/q coefficients (`initializeSubProblem`,
        `ParOptMMA.cpp:523-790`)."""
        o = self.options
        self.x2, self.x1 = self.x1, self.x
        self.x = xv

        fobj, cons = self.prob.eval_obj_con(self.x)
        self.fobj = fobj
        self.cons = cons.reshape(self.ncon)
        self.g, self.A = self.prob.eval_obj_con_gradient(self.x)
        if self.nwcon > 0:
            self.cw = self.prob.eval_sparse_con(self.x)

        # log this outer iteration
        if self._logger is not None:
            infeas, l1, linf = self.compute_kkt_error()
            fobj_f, l1_lambda = self.syncs.values(
                self.fobj, (torch.sum(torch.abs(self.z)) if self.ncon
                            else torch.zeros_like(self.fobj)))
            self._logger.log(self.mma_iter, self.subproblem_iter, fobj_f,
                             l1, linf, l1_lambda, infeas)

        x = self.x
        movlim = o["mma_move_limit"]
        lower = torch.maximum(self.lbv, x - movlim)
        upper = torch.minimum(self.ubv, x + movlim)

        if self.mma_iter < 2:
            off = o["mma_init_asymptote_offset"]
            self.L = x - off * (upper - lower)
            self.U = x + off * (upper - lower)
        else:
            min_off = o["mma_min_asymptote_offset"]
            max_off = o["mma_max_asymptote_offset"]
            indc = (x - self.x1) * (self.x1 - self.x2)
            intrvl = torch.clamp(upper - lower, 0.01, 100.0)
            # a tensor operand: two Python scalars would give float32
            fac = torch.where(indc < 0.0,
                              torch.full_like(indc,
                                              o["mma_asymptote_contract"]),
                              o["mma_asymptote_relax"])
            L = x - fac * (self.x1 - self.L)
            U = x + fac * (self.U - self.x1)
            L = torch.minimum(L, x - min_off * intrvl)
            U = torch.maximum(U, x + min_off * intrvl)
            self.L = torch.maximum(L, x - max_off * intrvl)
            self.U = torch.minimum(U, x + max_off * intrvl)

        # inner bounds α/β (`ParOptMMA.cpp:700-710`)
        self.alpha = torch.maximum(torch.maximum(lower,
                                                 0.9 * self.L + 0.1 * x),
                                   x - 0.5 * (upper - lower))
        self.beta = torch.minimum(torch.minimum(upper,
                                                0.9 * self.U + 0.1 * x),
                                  x + 0.5 * (upper - lower))

        eps = o["mma_eps_regularization"]
        delta = o["mma_delta_regularization"]
        gpos = torch.clamp(self.g, min=0.0)
        gneg = torch.clamp(-self.g, min=0.0)
        Umx = self.U - x
        xmL = x - self.L
        self.p0 = Umx ** 2 * ((1.0 + delta) * gpos + delta * gneg
                              + eps / (self.U - self.L))
        self.q0 = xmL ** 2 * ((1.0 + delta) * gneg + delta * gpos
                              + eps / (self.U - self.L))

        if self.use_true_mma and self.ncon > 0:
            # convex approximation of -c(x) (`ParOptMMA.cpp:689-734`)
            Apos = torch.clamp(-self.A, min=0.0)
            Aneg = torch.clamp(self.A, min=0.0)
            self.pi = Umx[None, :] ** 2 * Apos
            self.qi = xmL[None, :] ** 2 * Aneg
            bsum = torch.sum(self.pi / Umx[None, :]
                             + self.qi / xmL[None, :], dim=1)
            self.b = -(self.cons + bsum)

        self.mma_iter += 1

    def compute_kkt_error(self):
        """(infeas, l1, linfty) (`computeKKTError`, `ParOptMMA.cpp:
        406-488`): projected gradient of the true Lagrangian with bound
        relaxation."""
        relax = self.options["mma_bound_relax"]
        x = self.x
        r = self.g - self.A.T @ self.z if self.ncon else self.g
        if self.nwcon > 0:
            r = r - self.prob.sparse_jacobian_tvec(x, self.zw)
        if relax > 0.0:
            r = torch.where((x <= self.lbv + relax) & (r > 0.0), 0.0, r)
            r = torch.where((x >= self.ubv - relax) & (r < 0.0), 0.0, r)
        else:
            r = r - self.zl + self.zu
        zero = torch.zeros((), dtype=r.dtype, device=r.device)
        infeas = zero
        if self.ncon:
            infeas = infeas + torch.sum(_viol(self.cons, self.ninequality))
        if self.nwcon:
            infeas = infeas + torch.sum(_viol(self.cw, self.nwinequality))
        l1, linf, infeas = self.syncs.values(
            torch.sum(torch.abs(r)),
            torch.max(torch.abs(r)) if r.numel() else zero, infeas)
        return infeas, l1, linf

    # ------------------------------------------------------------------
    # the separable subproblem, as a Problem consumed by the IP
    # ------------------------------------------------------------------

    def get_vars_and_bounds(self):
        return self.x, self.alpha, self.beta

    def eval_obj_con(self, xv):
        """MMA approximation (`ParOptMMA::evalObjCon`, `ParOptMMA.cpp:
        804-868`)."""
        Uinv = 1.0 / (self.U - xv)
        Linv = 1.0 / (xv - self.L)
        f = torch.sum(self.p0 * Uinv + self.q0 * Linv)
        if self.ncon == 0:
            return f, xv.new_zeros(0)
        if self.use_true_mma:
            c = -(self.pi @ Uinv + self.qi @ Linv + self.b)
        else:
            c = self.cons + self.A @ (xv - self.x)
        return f, c

    def eval_obj_con_gradient(self, xv):
        self.subproblem_iter += 1
        Uinv = 1.0 / (self.U - xv)
        Linv = 1.0 / (xv - self.L)
        g = self.p0 * Uinv ** 2 - self.q0 * Linv ** 2
        if self.ncon == 0:
            return g, xv.new_zeros((0, self.nvars))
        if self.use_true_mma:
            A = self.qi * (Linv ** 2)[None, :] - self.pi * (Uinv ** 2)[None, :]
        else:
            A = self.A
        return g, A

    def eval_hessian_diag(self, xv, z, zw):
        """`ParOptMMA::evalHessianDiag` (`ParOptMMA.cpp:967-1010`)."""
        Uinv = 1.0 / (self.U - xv)
        Linv = 1.0 / (xv - self.L)
        h = 2.0 * (self.p0 * Uinv ** 3 + self.q0 * Linv ** 3)
        if self.use_true_mma and self.ncon > 0:
            h = h + 2.0 * (z @ (self.pi * (Uinv ** 3)[None, :]
                                + self.qi * (Linv ** 3)[None, :]))
        return h

    def eval_hvec_product(self, xv, z, zw, px):
        return self.eval_hessian_diag(xv, z, zw) * px

    # sparse constraints: linearized about the outer point x
    # (`ParOptMMA::evalSparseCon`, `ParOptMMA.cpp:1015-1050`)
    def eval_sparse_con(self, xv):
        return self.cw + self.prob.sparse_jacobian(self.x).matvec(xv - self.x)

    def sparse_jacobian(self, xv):
        return self.prob.sparse_jacobian(self.x)

    def write_output(self, it, xv):
        pass


class FusedMMAOptions(NamedTuple):
    """Outer-loop options (mirror the mma_* registry entries)."""
    max_iterations: int = 200
    infeas_tol: float = 1e-5
    l1_tol: float = 1e-6
    linf_tol: float = 1e-6
    move_limit: float = 0.2
    init_asymptote_offset: float = 0.25
    asymptote_contract: float = 0.7
    asymptote_relax: float = 1.2
    min_asymptote_offset: float = 0.01
    max_asymptote_offset: float = 10.0
    eps_regularization: float = 1e-5
    delta_regularization: float = 1e-3
    bound_relax: float = 0.0
    use_true_mma: bool = True
    ninequality: int = 0
    nwinequality: int = 0
    # 'none' (reference absolute test) | 'gradient' (relative to ||g||)
    kkt_error_scaling: str = "none"
    # no-improvement window (mma_max_no_improvement; 0 = disabled)
    max_no_improvement: int = 0


@pytree
@dataclasses.dataclass(frozen=True)
class FusedMMAState:
    """Outer-loop state."""
    x: torch.Tensor
    x1: torch.Tensor
    x2: torch.Tensor
    L: torch.Tensor
    U: torch.Tensor
    z: torch.Tensor
    zw: torch.Tensor
    zl: torch.Tensor
    zu: torch.Tensor
    fobj: torch.Tensor
    k: torch.Tensor            # outer iteration counter (int32)
    subiters: torch.Tensor     # cumulative inner IP iterations (int32)
    converged: torch.Tensor    # bool
    infeas: torch.Tensor
    l1: torch.Tensor
    linf: torch.Tensor
    best_l1: torch.Tensor      # best stationarity seen (stall detection)
    no_improve: torch.Tensor   # int32 consecutive non-improving iterations
    stalled: torch.Tensor      # bool: converged via the no-improvement exit


def _asymptote_factor(indc, mo: FusedMMAOptions):
    """Contract where the last two moves changed sign (indc < 0), relax
    elsewhere.  A tensor operand: with two Python scalars torch.where
    would return float32 whatever indc's dtype."""
    contract = torch.full_like(indc, mo.asymptote_contract)
    return torch.where(indc < 0.0, contract, mo.asymptote_relax)


class _MMAHead(NamedTuple):
    """An outer MMA iteration up to its inner solve."""
    converged: torch.Tensor
    stalled: torch.Tensor
    fobj: torch.Tensor
    infeas: torch.Tensor
    l1: torch.Tensor
    linf: torch.Tensor
    best_l1: torch.Tensor
    no_improve: torch.Tensor
    alpha: torch.Tensor     # the inner solve's bounds
    beta: torch.Tensor
    params: MMAParams       # the subproblem (its sparse pattern left out)


def _mma_head(user_model: ModelFns, mo: FusedMMAOptions, lbv, ubv,
              d_tmpl: ProblemData, params_user,
              state: FusedMMAState) -> _MMAHead:
    """Evaluate, update the asymptotes and coefficients, test convergence
    (the outer step before its inner solve)."""
    x, x1, x2 = state.x, state.x1, state.x2
    dt = x.dtype
    dev = x.device
    with span("paropt.mma.eval"):
        fobj, cons, cw = user_model.eval_obj_con(params_user, x)
        g, A = user_model.eval_grad(params_user, x)
    cons = cons.reshape(-1)

    # -- asymptotes (`ParOptMMA.cpp:615-664`) -------------------------------
    lower = torch.maximum(lbv, x - mo.move_limit)
    upper = torch.minimum(ubv, x + mo.move_limit)
    off = mo.init_asymptote_offset
    L_init = x - off * (upper - lower)
    U_init = x + off * (upper - lower)
    indc = (x - x1) * (x1 - x2)
    intrvl = torch.clamp(upper - lower, 0.01, 100.0)
    fac = _asymptote_factor(indc, mo)
    L_upd = torch.minimum(x - fac * (x1 - state.L),
                          x - mo.min_asymptote_offset * intrvl)
    U_upd = torch.maximum(x + fac * (state.U - x1),
                          x + mo.min_asymptote_offset * intrvl)
    L_upd = torch.maximum(L_upd, x - mo.max_asymptote_offset * intrvl)
    U_upd = torch.minimum(U_upd, x + mo.max_asymptote_offset * intrvl)
    first = state.k < 2
    L = torch.where(first, L_init, L_upd)
    U = torch.where(first, U_init, U_upd)

    # -- inner bounds + p/q coefficients (`ParOptMMA.cpp:689-734`) ----------
    alpha = torch.maximum(torch.maximum(lower, 0.9 * L + 0.1 * x),
                          x - 0.5 * (upper - lower))
    beta = torch.minimum(torch.minimum(upper, 0.9 * U + 0.1 * x),
                         x + 0.5 * (upper - lower))
    eps, delta = mo.eps_regularization, mo.delta_regularization
    gpos = torch.clamp(g, min=0.0)
    gneg = torch.clamp(-g, min=0.0)
    Umx = U - x
    xmL = x - L
    p0 = Umx ** 2 * ((1.0 + delta) * gpos + delta * gneg + eps / (U - L))
    q0 = xmL ** 2 * ((1.0 + delta) * gneg + delta * gpos + eps / (U - L))
    ncon = cons.shape[0]
    if mo.use_true_mma and ncon > 0:
        Apos = torch.clamp(-A, min=0.0)
        Aneg = torch.clamp(A, min=0.0)
        pi = Umx[None, :] ** 2 * Apos
        qi = xmL[None, :] ** 2 * Aneg
        b = -(cons + torch.sum(pi / Umx[None, :] + qi / xmL[None, :], dim=1))
    else:
        pi = torch.zeros((ncon, x.shape[0]), dtype=dt, device=dev)
        qi = torch.zeros((ncon, x.shape[0]), dtype=dt, device=dev)
        b = torch.zeros(ncon, dtype=dt, device=dev)

    # -- KKT error at x with the incoming multipliers (`computeKKTError`,
    #    `ParOptMMA.cpp:406-488`) -------------------------------------------
    r = g - A.T @ state.z if ncon else g
    if d_tmpl.nwcon > 0:
        r = r - d_tmpl.Aw_rmatvec(state.zw)
    if mo.bound_relax > 0.0:
        r = torch.where((x <= lbv + mo.bound_relax) & (r > 0.0), 0.0, r)
        r = torch.where((x >= ubv - mo.bound_relax) & (r < 0.0), 0.0, r)
    else:
        r = r - state.zl + state.zu
    zero = torch.zeros((), dtype=dt, device=dev)
    l1 = torch.sum(torch.abs(r))
    linf = torch.max(torch.abs(r)) if r.numel() else zero
    infeas = zero
    if ncon:
        idx = torch.arange(ncon, device=dev)
        infeas = torch.sum(torch.where(idx < mo.ninequality,
                                       torch.clamp(-cons, min=0.0),
                                       torch.abs(cons)))
    if d_tmpl.nwcon:
        idxw = torch.arange(d_tmpl.nwcon, device=dev)
        infeas = infeas + torch.sum(
            torch.where(idxw < mo.nwinequality, torch.clamp(-cw, min=0.0),
                        torch.abs(cw)))
    if mo.kkt_error_scaling == "gradient":
        # relative stationarity: scale the tolerances by the objective
        # gradient norms
        s1 = torch.clamp(torch.sum(torch.abs(g)), min=1.0)
        sinf = torch.clamp(torch.max(torch.abs(g)), min=1.0)
    else:
        s1 = sinf = zero + 1.0
    tol_met = (l1 < mo.l1_tol * s1) | (linf < mo.linf_tol * sinf)
    # no-improvement window (mma_max_no_improvement): terminate at the
    # arithmetic-noise stationarity floor; frozen once converged
    active = (state.k > 0) & ~state.converged
    improved = l1 < state.best_l1
    best_new = torch.where(active & improved, l1, state.best_l1)
    no_imp_new = torch.where(
        active, torch.where(improved, torch.zeros_like(state.no_improve),
                            state.no_improve + 1),
        state.no_improve)
    stall_exit = torch.zeros((), dtype=torch.bool, device=dev)
    if mo.max_no_improvement > 0:
        stall_exit = no_imp_new >= mo.max_no_improvement
    converged = ((state.k > 0) & (infeas < mo.infeas_tol)
                 & (tol_met | stall_exit))
    stalled = state.stalled | (converged & ~state.converged & stall_exit
                               & ~tol_met)
    params = MMAParams(L=L, U=U, p0=p0, q0=q0, pi=pi, qi=qi, b=b, cons=cons,
                       A=A, x0=x, cwk=cw, Aw_cols=None, Aw_vals=None)
    return _MMAHead(converged=converged, stalled=stalled, fobj=fobj.to(dt),
                    infeas=infeas, l1=l1, linf=linf, best_l1=best_new,
                    no_improve=no_imp_new, alpha=alpha, beta=beta,
                    params=params)


def _skip_inner(state: FusedMMAState):
    """The inner solve's outputs when it is skipped: the incoming point
    and multipliers, no inner iteration."""
    return (state.x, state.z, state.zw, state.zl, state.zu,
            torch.zeros_like(state.k))


def _pick_inner(skip, state: FusedMMAState, inner):
    return tuple(torch.where(skip, a, b)
                 for a, b in zip(_skip_inner(state), inner))


def _mma_tail(state: FusedMMAState, head: _MMAHead, inner) -> FusedMMAState:
    xn, zn, zwn, zln, zun, kin = inner
    converged = head.converged
    return FusedMMAState(
        x=xn, x1=torch.where(converged, state.x1, state.x),
        x2=torch.where(converged, state.x2, state.x1),
        L=head.params.L, U=head.params.U, z=zn, zw=zwn, zl=zln, zu=zun,
        fobj=head.fobj, k=state.k + (~converged).to(state.k.dtype),
        subiters=state.subiters + kin, converged=converged,
        infeas=head.infeas, l1=head.l1, linf=head.linf,
        best_l1=head.best_l1, no_improve=head.no_improve,
        stalled=head.stalled)


@spanned("paropt.mma.outer")
def _fused_mma_step(user_model: ModelFns, mma_model: ModelFns,
                    ip_opts: FusedIPOptions, mo: FusedMMAOptions,
                    lbv, ubv, d_tmpl: ProblemData, params_user,
                    state: FusedMMAState, host=bool,
                    run: Optional[_Run] = None) -> FusedMMAState:
    """One outer MMA iteration: evaluate, update asymptotes/coeffs, test
    convergence, inner-solve (skipped once converged).  ``host`` reads a
    device flag on the host.  A batched ``run`` steps k instances: the
    inner solve is skipped once every instance is converged, and runs
    batched otherwise, the converged instances keeping their point."""
    R = run or _Run(host)
    head = R.call(functools.partial(_mma_head, user_model, mo, lbv, ubv,
                                    d_tmpl, params_user), (0,), state)
    skip = head.converged | state.converged if R.batched else head.converged
    # -- inner fused IP solve (skipped once converged) -----------------------
    if R.all(skip):
        inner = R.call(_skip_inner, (0,), state)
    else:
        params = head.params._replace(Aw_cols=d_tmpl.Aw_cols,
                                      Aw_vals=d_tmpl.Aw_vals)
        d = dataclasses.replace(d_tmpl, lb=head.alpha, ub=head.beta)
        # the instance axes of (d, params): the bounds and the subproblem
        # coefficients are per instance, the rest is shared
        da = dataclasses.replace(tmap(lambda _: None, d_tmpl), lb=0, ub=0)
        pa = params._replace(**{f: 0 for f in MMAParams._fields
                                if f not in ("Aw_cols", "Aw_vals")},
                             Aw_cols=None, Aw_vals=None)
        with span("paropt.mma.inner_ip"):
            st0 = R.call(functools.partial(_fused_init, mma_model, ip_opts),
                         (0, da, pa, None, None), state.x, d, params, None,
                         None)
            if R.batched:
                # the instances that skip the solve start it converged
                st0 = dataclasses.replace(st0, converged=skip)
            st = _fused_solve_loop(mma_model, ip_opts, st0, d, params, None,
                                   host, run=R, axes=(da, pa, None))
        v = st.vars
        inner = (v.x, v.z, v.zw, v.zl, v.zu, st.k)
        if R.batched:
            inner = R.call(_pick_inner, (0, 0, 0), skip, state, inner)
    return R.call(_mma_tail, (0, 0, 0), state, head, inner)


class FusedMMA:
    """Fused MMA solver for a problem written in torch, on the problem's
    device.  The problem's sparse Jacobian (if any) must be CONSTANT in x:
    its values are captured once at x0.  Options use the standard
    mma_*/IP registry names; ``dtype`` selects the solver's precision."""

    def __init__(self, problem, options: Optional[Dict[str, Any]] = None):
        o = options if hasattr(options, "descriptors") else \
            make_options(options or {}, which="facade")
        dt = torch.float64 if o["dtype"] == "float64" else torch.float32
        x0, lb, ub = problem.get_vars_and_bounds()
        dev = x0.device
        kw = dict(dtype=dt, device=dev)
        x0, lbv, ubv = x0.to(dt), lb.to(dt), ub.to(dt)
        n, ncon, nwcon = problem.nvars, problem.ncon, problem.nwcon

        def ev(params, x):
            f, c = problem.eval_obj_con(x)
            cwv = (problem.eval_sparse_con(x) if nwcon > 0
                   else x.new_zeros(0))
            return f, c.reshape(ncon), cwv

        def gr(params, x):
            return problem.eval_obj_con_gradient(x)

        user_model = ModelFns(eval_obj_con=ev, eval_grad=gr)

        use_true = not o["mma_use_constraint_linearization"]
        mma_model = make_mma_model(use_true, nwcon > 0)
        gamma = o["penalty_gamma"]
        if nwcon > 0:
            Aw = problem.sparse_jacobian(x0)
            cols, vals, layout = Aw.cols, Aw.vals.to(dt), Aw.layout
        else:
            cols = vals = None
            layout = "gather"
        ones = torch.ones(n, **kw)
        d_tmpl = ProblemData(
            g=torch.zeros(n, **kw), A=torch.zeros((ncon, n), **kw),
            c=torch.zeros(ncon, **kw), cw=torch.zeros(nwcon, **kw),
            lb=lbv, ub=ubv, lb_mask=ones, ub_mask=ones,
            gamma_s=torch.as_tensor(
                np.where(np.arange(ncon) < problem.ninequality, 0.0, gamma),
                **kw),
            gamma_t=torch.full((ncon,), gamma, **kw),
            gamma_sw=torch.as_tensor(
                np.where(np.arange(nwcon) < problem.nwinequality, 0.0,
                         gamma), **kw),
            gamma_tw=torch.full((nwcon,), gamma, **kw),
            Aw_cols=cols, Aw_vals=vals, nwblock=problem.nwblock,
            Aw_layout=layout)
        ip_opts = FusedIPOptions(
            abs_res_tol=o["abs_res_tol"],
            init_barrier_param=o["init_barrier_param"],
            barrier_strategy=o["barrier_strategy"],
            starting_point_strategy=o["starting_point_strategy"],
            max_major_iters=o["max_major_iters"],
            iterative_refinement_steps=o["iterative_refinement_steps"],
            use_line_search=False, use_diag_hessian=True,
            norm_type=o["norm_type"])
        mo = FusedMMAOptions(
            max_iterations=o["mma_max_iterations"],
            infeas_tol=o["mma_infeas_tol"], l1_tol=o["mma_l1_tol"],
            linf_tol=o["mma_linfty_tol"], move_limit=o["mma_move_limit"],
            init_asymptote_offset=o["mma_init_asymptote_offset"],
            asymptote_contract=o["mma_asymptote_contract"],
            asymptote_relax=o["mma_asymptote_relax"],
            min_asymptote_offset=o["mma_min_asymptote_offset"],
            max_asymptote_offset=o["mma_max_asymptote_offset"],
            eps_regularization=o["mma_eps_regularization"],
            delta_regularization=o["mma_delta_regularization"],
            bound_relax=o["mma_bound_relax"], use_true_mma=use_true,
            ninequality=problem.ninequality,
            nwinequality=problem.nwinequality,
            kkt_error_scaling=o["mma_kkt_error_scaling"],
            max_no_improvement=o["mma_max_no_improvement"])

        zero = torch.zeros((), **kw)
        zero_i = torch.zeros((), dtype=torch.int32, device=dev)
        false = torch.zeros((), dtype=torch.bool, device=dev)
        self._state0 = FusedMMAState(
            x=x0, x1=x0, x2=x0, L=torch.zeros(n, **kw),
            U=torch.zeros(n, **kw), z=torch.zeros(ncon, **kw),
            zw=torch.zeros(nwcon, **kw), zl=torch.zeros(n, **kw),
            zu=torch.zeros(n, **kw), fobj=zero, k=zero_i, subiters=zero_i,
            converged=false, infeas=zero, l1=zero, linf=zero,
            best_l1=zero + float("inf"), no_improve=zero_i, stalled=false)
        self.syncs = HostSyncs()
        self._mo = mo
        self._ev = ev
        self._problem = problem
        self._write_freq = o["write_output_frequency"]
        self._step = functools.partial(
            _fused_mma_step, user_model, mma_model, ip_opts, mo, lbv, ubv,
            d_tmpl, (), host=self.syncs)

    @spmd
    def solve(self, state0: Optional[FusedMMAState] = None,
              jit_loop: bool = True, chunk="auto", checkpoint_path=None):
        """Run the outer loop (paropt_tpu/mma.py:766-813); returns (result
        dict, final state).  Pass a previous final state to resume.

        ``jit_loop=True`` (default): the loop stops at the absolute count
        ``mma_max_iterations``, run in windows of ``chunk`` outer
        iterations by `utils.chunked.run_chunked` (an int, ``'auto'``: one
        timed outer iteration sizes them to ~10 s, or None: one window).
        ``jit_loop=False``: ``mma_max_iterations`` more outer iterations
        from the state given, the hook after each.  Both read
        ``converged`` on the host after every outer iteration; nothing is
        compiled, so every form runs the same eager steps and the final
        state is the same under any chunk.  The problem's
        ``write_output(it, x)`` hook fires every ``write_output_frequency``
        outer iterations at window boundaries, and ``checkpoint_path`` gets
        the full state at the same cadence (`utils.checkpoint`)."""
        from .utils.chunked import (host_reader, make_write_output_hook,
                                    outer_loop, user_write_output)
        hook = make_write_output_hook(
            user_write_output(self._problem), self._write_freq,
            get_x=lambda st: st.x, checkpoint_path=checkpoint_path,
            syncs=self.syncs)
        state = state0 if state0 is not None else self._state0
        state = outer_loop(self._step, lambda st: self.syncs(st.converged),
                           state, self._mo.max_iterations, jit_loop, chunk,
                           on_chunk=hook, read=host_reader(self.syncs))
        # state.fobj is the value at the point the LAST step evaluated;
        # when the loop exits at the iteration cap, x has advanced once
        fobj_final, _, _ = self._ev((), state.x)
        fobj, conv, stalled, k, infeas, l1, linf = self.syncs.values(
            fobj_final, state.converged, state.stalled, state.k,
            state.infeas, state.l1, state.linf)
        result = {"x": state.x, "fobj": fobj, "converged": bool(conv),
                  "stalled": bool(stalled), "niter": int(k),
                  "infeas": infeas, "l1": l1, "linfty": linf}
        return result, state

    def solve_batched(self, x0_batch, chunk="auto"):
        """k multi-start solves as one (paropt_tpu/mma.py:815-855): the
        outer step's phases and the inner IP solves run batched under
        ``torch.func.vmap``, one host read of "every instance converged"
        per outer iteration; an instance that has converged keeps its
        state bit for bit while the others iterate.

        ``x0_batch``: [k, n] starting designs.  ``chunk``: the windows of
        `utils.chunked.run_chunked_batched` (an int, ``'auto'`` or None);
        the result is the same under any.  Returns (results, states):
        ``results`` holds per-instance numpy arrays of fobj, converged,
        stalled, niter, infeas, l1 and linfty (and x [k, n]); ``states`` is
        the `FusedMMAState` with a leading k axis."""
        from .utils.chunked import (batch_reader, run_chunked_batched,
                                    step_until)
        run = _Run(self.syncs, batched=True)
        s0 = self._state0
        x0_batch = torch.as_tensor(x0_batch, dtype=s0.x.dtype,
                                   device=s0.x.device)
        state = run.call(
            lambda st, x: dataclasses.replace(st, x=x, x1=x, x2=x),
            (None, 0), s0, x0_batch)

        def step(st):
            return run.freeze(st.converged, self._step(st, run=run), st)

        state = run_chunked_batched(
            lambda st, k, k_stop: step_until(
                step, lambda s: run.all(s.converged), st, k, k_stop),
            state, self._mo.max_iterations, chunk,
            read=batch_reader(self.syncs))
        fobj_final = run.call(lambda x: self._ev((), x)[0], (0,), state.x)
        results = {"x": state.x, "fobj": fobj_final.cpu().numpy(),
                   **{key: getattr(state, f).cpu().numpy() for key, f in (
                       ("converged", "converged"), ("stalled", "stalled"),
                       ("niter", "k"), ("infeas", "infeas"), ("l1", "l1"),
                       ("linfty", "linf"))}}
        return results, state


# bounded strong-reference LRU: a weak-value cache would evict the solver
# the moment fused_mma_solve returns (nothing else holds it)
_FUSED_MMA_CACHE: "OrderedDict" = OrderedDict()
_FUSED_MMA_CACHE_MAX = 8


def fused_mma_solve(problem, options: Optional[Dict[str, Any]] = None,
                    jit_loop: bool = True, chunk="auto"):
    """One-shot convenience wrapper over `FusedMMA` (build + solve).

    The built solver is cached per (problem, options), so back-to-back
    calls reuse it.  The cache holds strong references to the last few
    solvers (LRU, size 8); problem identity is re-checked through a weakref
    so a recycled id() cannot alias a dead problem."""
    if hasattr(options, "descriptors"):
        key = None  # registry objects are mutable; don't cache
    else:
        try:
            key = (id(problem), tuple(sorted((options or {}).items())))
            hash(key)
        except TypeError:  # unhashable option values
            key = None
    solver = _FUSED_MMA_CACHE.get(key) if key is not None else None
    if solver is None or solver._problem_ref() is not problem:
        solver = FusedMMA(problem, options)
        solver._problem_ref = weakref.ref(problem)
        if key is not None:
            _FUSED_MMA_CACHE[key] = solver
            _FUSED_MMA_CACHE.move_to_end(key)
            while len(_FUSED_MMA_CACHE) > _FUSED_MMA_CACHE_MAX:
                _FUSED_MMA_CACHE.popitem(last=False)
    elif key is not None:
        _FUSED_MMA_CACHE.move_to_end(key)
    return solver.solve(jit_loop=jit_loop, chunk=chunk)
