"""The trust region: the host-loop `TrustRegion` (SL1QP with the adaptive
per-constraint penalties, the filter method with second-order correction)
and the fused SL1QP outer loop `FusedTR` (counterpart of paropt_tpu/tr.py,
where the method is documented), with the registry -> `FusedIPOptions`
mapping shared with the facade's fused IP solve.

Each outer iteration builds the trust-region box about xk, runs the
steering infeasibility solve and the QP solve with the fused interior-point
solver on a quadratic model of the problem (compact quasi-Newton objective,
linearized constraints), evaluates the trial point once, updates the
quasi-Newton state, accepts or rejects the step, resizes the radius, adapts
the penalties and tests the normalized KKT error.

`TrustRegion` makes these decisions on the host, as the JAX package's does:
its `QuadraticSubproblem` and `InfeasSubproblem` are `Problem`s over the
step, its inner solves are `FusedIP`s on the QP model (a custom subproblem
runs the host `InteriorPoint` instead), and every decision reads device
scalars; ``TrustRegion.syncs`` counts those reads, the inner solves'
included.  `FusedTR` keeps the whole outer iteration on the device; the JAX
package runs it as one ``lax.while_loop``, here it is a host loop that reads
``converged`` once per outer iteration, and the inner solves read the device
once per line-search trial and once per step (``FusedTR.syncs``).

`FusedTR.solve_batched` runs k multi-start solves as one: the outer
step's phases (`_tr_head`, the steering and QP solves, `_tr_tail`) under
``torch.func.vmap``.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .ip import HostSyncs, InteriorPoint
from .ip_fused import (FusedIP, FusedIPOptions, ModelFns, _fused_init,
                       _fused_solve_loop, _Run)
from .ops import qn as qnmod
from .ops.kkt import ProblemData
from .ops.veclib import matmul
from .problem import Problem
from .tree import pytree, tmap
from .utils.logging import TRLogger
from .utils.options import OptionRegistry, make_options
from .utils.spans import span

__all__ = ["TrustRegion", "QuadraticSubproblem", "InfeasSubproblem",
           "QPParams", "make_qp_model", "FusedTR", "FusedTROptions",
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
    # optional low-rank quadratic curvature of ONE constraint row (the
    # eigen row, `ParOptCompactEigenvalueApprox.cpp:598-635`): row model
    # c[i] + A[i]·p + 1/2 (h p)' M_eig (h p); read only by a model built
    # with ``eig_index``
    eig_M: Any = None   # [N, N]
    eig_h: Any = None   # [N, n]


def _qp_Bp(params: QPParams, p):
    """B p for the compact form in ``params``: `qn_mult`'s formula, which
    the outer step's model reduction also uses."""
    if params.Z is None:
        return params.b0 * p
    return qnmod.qn_mult(None, p, compact=(params.b0, params.Z, params.M))


def _with_row(a, index: int, val):
    """``a`` with its row ``index`` replaced by ``val`` (out of place; the
    other rows are returned untouched, even when ``val`` is not finite)."""
    rows = torch.arange(a.shape[0], device=a.device)
    rows = rows.reshape((-1,) + (1,) * (a.dim() - 1))
    return torch.where(rows == index, val, a)


def _add_row(a, index: int, val):
    """``a`` with ``val`` added to its row ``index`` (see `_with_row`)."""
    return _with_row(a, index, a[index] + val)


def make_qp_model(has_sparse: bool, obj_mode: str,
                  eig_index: Optional[int] = None) -> ModelFns:
    """Model functions of the (possibly sparse-constrained) QP subproblem;
    ``obj_mode`` is 'quadratic' or 'linear'.  ``eig_index`` makes constraint
    row ``eig_index`` quadratic through ``params.eig_M`` / ``eig_h``, as the
    reference's `ParOptEigenSubproblem::evalObjCon` does
    (`ParOptCompactEigenvalueApprox.cpp:598-635`); without it those fields
    are ignored."""

    def ev(params: QPParams, p):
        f = params.fk + torch.dot(params.gk, p)
        if obj_mode == "quadratic":
            f = f + 0.5 * torch.dot(p, _qp_Bp(params, p))
        f = params.obj_scale * f
        c = (params.ck + params.Ak @ p) if params.ck.shape[0] else params.ck
        if eig_index is not None:
            hp = params.eig_h @ p
            c = _add_row(c, eig_index,
                         0.5 * torch.dot(hp, params.eig_M @ hp))
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
        A = params.Ak
        if eig_index is not None:
            hp = params.eig_h @ p
            A = _add_row(A, eig_index, params.eig_h.T @ (params.eig_M @ hp))
        return params.obj_scale * g, A

    return ModelFns(eval_obj_con=ev, eval_grad=gr, hess_diag=None)


# ---------------------------------------------------------------------------
# the host-loop trust region
# ---------------------------------------------------------------------------


def _viol(c, nineq):
    """Per-constraint violation: max(0, -c) for inequalities, |c| for
    equalities (`ParOptTrustRegion.cpp:1620-1665`)."""
    if c.shape[0] == 0:
        return c
    idx = torch.arange(c.shape[0], device=c.device)
    return torch.where(idx < nineq, torch.clamp(-c, min=0.0), torch.abs(c))


def _l1_violation(c, nineq, gamma=None):
    """Σ γ_i · viol_i with viol = max(0, -c) for inequalities, |c| for
    equalities."""
    if c.shape[0] == 0:
        return torch.zeros((), dtype=c.dtype, device=c.device)
    viol = _viol(c, nineq)
    if gamma is not None:
        viol = gamma * viol
    return torch.sum(viol)


class QuadraticSubproblem(Problem):
    """Quadratic/linear model of the user problem about xk, expressed in the
    step variable p (`ParOptQuadraticSubproblem`, `ParOptTrustRegion.cpp:
    41-419`):

        min  fk + gk·p + 1/2 p·B·p
        s.t. ck + Ak·p >= 0,   cwk + Awk·p >= 0,
             max(-Δ, lb-xk) <= p <= min(Δ, ub-xk)

    with B the compact quasi-Newton approximation shared with the solvers
    through the qn holder.  ``syncs`` counts the subproblem's host reads."""

    def __init__(self, problem: Problem, qn_holder: Dict[str, Any]):
        super().__init__(nvars=problem.nvars, ncon=problem.ncon,
                         nwcon=problem.nwcon, nwblock=problem.nwblock,
                         ninequality=problem.ninequality,
                         nwinequality=problem.nwinequality)
        self.prob = problem
        self.qn_holder = qn_holder
        self.syncs = HostSyncs()
        self.xk, self.lb, self.ub = problem.get_vars_and_bounds()
        self.lk = self.lb - self.xk
        self.uk = self.ub - self.xk
        # linearization data (filled by init_model)
        self.fk = self.gk = self.ck = self.Ak = self.cwk = None
        self.Awk = None
        # trial-point cache
        self.ft = self.ct = self.gt = self.At = None
        self.qn_update_type = (0, 0)  # (skipped, damped)
        # second-order-correction state
        self.c_soc = None
        self.is_soc_step = False

    def _as(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=self.xk.dtype, device=self.xk.device)

    # -- model management ----------------------------------------------------

    def _linearize(self):
        if self.nwcon > 0:
            self.cwk = self._as(self.prob.eval_sparse_con(self.xk))
            self.Awk = self.prob.sparse_jacobian(self.xk)

    def init_model(self, tr_size: float):
        """`initModelAndBounds` (`ParOptTrustRegion.cpp:1087-1105`):
        evaluate the real function/gradients at xk and set TR bounds."""
        fobj, c = self.prob.eval_obj_con(self.xk)
        self.fk = self._as(fobj)
        self.ck = self._as(c).reshape(self.ncon)
        self.gk, self.Ak = self.prob.eval_obj_con_gradient(self.xk)
        self._linearize()
        self.set_trust_region_bounds(tr_size)

    def set_trust_region_bounds(self, tr_size: float):
        self.lk = torch.clamp(self.lb - self.xk, min=-tr_size)
        self.uk = torch.clamp(self.ub - self.xk, max=tr_size)

    def _lagrangian_gradient(self, g, A, x, z, zw):
        y = g - matmul(A.T, z) if self.ncon else g
        if self.nwcon > 0:
            y = y - self.prob.sparse_jacobian_tvec(x, zw)
        return y

    def eval_trial_step_and_update(self, update_flag: bool, p, z, zw):
        """Evaluate the REAL objective/constraints/gradients at xk + p and
        update the quasi-Newton pair (`evalTrialStepAndUpdate`,
        `ParOptTrustRegion.cpp:172-212`). Returns (ft, ct)."""
        xt = self.xk + p
        # old-point Lagrangian gradient BEFORE the new evaluation (stateful
        # problems overwrite their stored Jacobian on evaluation)
        qn = self.qn_holder.get("state")
        update = qn is not None and update_flag
        if update:
            y0 = self._lagrangian_gradient(self.gk, self.Ak, self.xk, z, zw)
        ft, ct = self.prob.eval_obj_con(xt)
        self.ft = self._as(ft)
        self.ct = self._as(ct).reshape(self.ncon)
        self.gt, self.At = self.prob.eval_obj_con_gradient(xt)
        self.qn_update_type = (0, 0)
        if update:
            y = self._lagrangian_gradient(self.gt, self.At, xt, z, zw) - y0
            s, y = self.prob.compute_quasi_newton_update_correction(
                xt, z, zw, p, y)
            new_qn, skipped, damped = qnmod.qn_update(qn, s, y)
            self.qn_holder["state"] = new_qn
            self.qn_update_type = tuple(
                int(f) for f in self.syncs.values(skipped, damped))
        return self.ft, self.ct

    def accept_trial_step(self, p):
        """`acceptTrialStep` (`ParOptTrustRegion.cpp:215-229`)."""
        self.xk = self.xk + p
        self.fk, self.ck, self.gk, self.Ak = self.ft, self.ct, self.gt, \
            self.At
        self._linearize()

    def reject_trial_step(self):
        self.ft = None
        self.ct = None

    # -- second-order correction (`updateSocCon`/`startSecondOrderCorrection`)
    def update_soc_con(self, step, ct):
        """c_soc = c(xk + step) - Ak*step, so the linearized model about the
        SOC origin reproduces the actual constraint values at the rejected
        trial point."""
        self.c_soc = self._as(ct) - (self.Ak @ step if self.ncon
                                     else self._as(ct))

    def start_soc(self):
        self.is_soc_step = True

    def end_soc(self):
        self.is_soc_step = False

    # -- Problem interface (in the step variable p) --------------------------

    def get_vars_and_bounds(self):
        return 0.5 * (self.lk + self.uk), self.lk, self.uk

    def model_obj_con(self, p=None):
        """Model objective/constraints (`evalObjCon`,
        `ParOptTrustRegion.cpp:289-325`); p=None means p=0."""
        if p is None:
            return self.fk, self.ck
        f = self.fk + torch.dot(self.gk, p)
        qn = self.qn_holder.get("state")
        if qn is not None:
            f = f + 0.5 * torch.dot(p, qnmod.qn_mult(qn, p))
        cbase = self.c_soc if self.is_soc_step else self.ck
        c = (cbase + self.Ak @ p) if self.ncon else self.ck
        return f, c

    def eval_obj_con(self, p):
        return self.model_obj_con(p)

    def eval_obj_con_gradient(self, p):
        qn = self.qn_holder.get("state")
        g = self.gk + qnmod.qn_mult(qn, p) if qn is not None else self.gk
        return g, self.Ak

    def eval_sparse_con(self, p):
        return self.cwk + self.Awk.matvec(p)

    def sparse_jacobian(self, p):
        return self.Awk

    def write_output(self, it, p):
        pass


class InfeasSubproblem(Problem):
    """Infeasibility-minimization subproblem for the adaptive-penalty
    "steering" strategy and filter restoration (`ParOptInfeasSubproblem`,
    `ParOptTrustRegion.cpp:430-658`): the quadratic subproblem's
    constraints and bounds with a scaled constant/linear/quadratic
    objective, so the IP's elastic slacks with unit penalties minimize the
    l1 constraint violation."""

    def __init__(self, sub: QuadraticSubproblem,
                 objective_type: str = "linear_objective",
                 constraint_type: str = "linear_constraint"):
        super().__init__(nvars=sub.nvars, ncon=sub.ncon, nwcon=sub.nwcon,
                         nwblock=sub.nwblock, ninequality=sub.ninequality,
                         nwinequality=sub.nwinequality)
        self.sub = sub
        self.objective_type = objective_type
        self.constraint_type = constraint_type
        self.obj_scale = 1.0

    def get_vars_and_bounds(self):
        return self.sub.get_vars_and_bounds()

    def eval_obj_con(self, p):
        s = self.sub
        if self.objective_type == "constant_objective":
            f = s.fk
        elif self.objective_type == "subproblem_objective":
            f, _ = s.model_obj_con(p)
        else:  # linear_objective
            f = s.fk + torch.dot(s.gk, p)
        if self.constraint_type == "subproblem_constraint":
            _, c = s.model_obj_con(p)
        else:
            c = (s.ck + s.Ak @ p) if s.ncon else s.ck
        return self.obj_scale * f, c

    def eval_obj_con_gradient(self, p):
        s = self.sub
        if self.objective_type == "constant_objective":
            g = torch.zeros_like(s.gk)
        elif self.objective_type == "subproblem_objective":
            g, _ = s.eval_obj_con_gradient(p)
        else:
            g = s.gk
        return self.obj_scale * g, s.Ak

    def eval_sparse_con(self, p):
        return self.sub.eval_sparse_con(p)

    def sparse_jacobian(self, p):
        return self.sub.Awk

    def write_output(self, it, p):
        pass


class TrustRegion:
    """Trust-region outer loop (`ParOptTrustRegion`), the reference's default
    algorithm, on the device of the problem's x0.  ``subproblem`` installs a
    custom model (`ParOptOptimizer::setTrustRegionSubproblem`): its inner
    solves run the host `InteriorPoint`, since its models are not plain
    QPs.  ``tr_output_file`` None writes no log."""

    def __init__(self, problem: Problem, options: Optional[Any] = None,
                 subproblem: Optional[QuadraticSubproblem] = None):
        self.problem = problem
        if isinstance(options, OptionRegistry):
            self.options = options
        else:
            self.options = make_options(options, which="facade")
        o = self.options
        self._custom_sub = subproblem is not None
        if self._custom_sub:
            self.subproblem = subproblem
            self.qn_holder = subproblem.qn_holder
        else:
            self.qn_holder: Dict[str, Any] = {"state": None}
            self.subproblem = QuadraticSubproblem(problem, self.qn_holder)
        # one counter for every host read of the solve, the inner solves'
        # included
        self.syncs = getattr(self.subproblem, "syncs", None) or HostSyncs()

        # per-constraint penalties, adaptively updated
        self.penalty_gamma = np.full(problem.ncon, o["penalty_gamma"])
        self.tr_size = o["tr_init_size"]
        self.iter_count = 0
        self._logger = None

        # the IP solver over the quadratic subproblem
        ip_opts = self.options.copy()
        ip_opts["use_quasi_newton_update"] = False
        ip_opts["write_output_frequency"] = 0
        ip_opts["output_file"] = None
        self.ip = InteriorPoint(self.subproblem, ip_opts)
        self.ip.syncs = self.syncs
        self.device = self.ip.device
        if not self._custom_sub:
            self._init_ip_qn()
        self.ip.set_quasi_newton_holder(self.qn_holder)

        # steering / restoration solver over the infeasibility subproblem
        self.infeas_problem = InfeasSubproblem(
            self.subproblem, o["tr_adaptive_objective"],
            o["tr_adaptive_constraint"])
        inf_opts = self.options.copy()
        inf_opts["use_quasi_newton_update"] = False
        inf_opts["write_output_frequency"] = 0
        inf_opts["output_file"] = None
        if (o["tr_adaptive_objective"] in ("linear_objective",
                                           "constant_objective")
                and o["tr_adaptive_constraint"] == "linear_constraint"):
            inf_opts["sequential_linear_method"] = True
        if o["tr_steering_barrier_strategy"] != "default":
            inf_opts["barrier_strategy"] = o["tr_steering_barrier_strategy"]
        if o["tr_steering_starting_point_strategy"] != "default":
            inf_opts["starting_point_strategy"] = (
                o["tr_steering_starting_point_strategy"])
        self.ip_infeas = InteriorPoint(self.infeas_problem, inf_opts)
        self.ip_infeas.syncs = self.syncs
        self.ip_infeas.set_penalty_gamma(1.0)

        self.filter: List[Tuple[float, float]] = []

        # fused-IP inner solvers, built on the first solve
        self._fused_qp: Optional[FusedIP] = None
        self._fused_infeas: Optional[FusedIP] = None
        self.subproblem_iters = 0
        # inner IP iterations of every QP and steering solve so far
        self.inner_iters = 0

    # -- fused inner solver --------------------------------------------------

    def _build_fused(self):
        o = self.options
        prob = self.problem
        n, ncon, nwcon = prob.nvars, prob.ncon, prob.nwcon
        has_sp = nwcon > 0
        self._fused_qp = FusedIP(
            make_qp_model(has_sp, "quadratic"), n, ncon, nwcon,
            prob.nwblock,
            _fused_ip_options(o, o["barrier_strategy"],
                              o["starting_point_strategy"], False),
            dtype=self.ip.dtype)
        quad = o["tr_adaptive_objective"] == "subproblem_objective"
        slm = (not quad
               and o["tr_adaptive_constraint"] == "linear_constraint")
        self._fused_infeas = FusedIP(
            make_qp_model(has_sp, "quadratic" if quad else "linear"), n,
            ncon, nwcon, prob.nwblock,
            _fused_ip_options(o, o["tr_steering_barrier_strategy"],
                              o["tr_steering_starting_point_strategy"], slm),
            dtype=self.ip.dtype)
        self._fused_qp.syncs = self._fused_infeas.syncs = self.syncs

    def _fused_data(self, gamma_s, gamma_t, gamma_scalar_sparse
                    ) -> ProblemData:
        sub = self.subproblem
        kw = dict(dtype=self.ip.dtype, device=self.device)
        n, ncon, nwcon = sub.nvars, sub.ncon, sub.nwcon
        ones = torch.ones(n, **kw)
        if nwcon > 0:
            cols, vals = sub.Awk.cols, sub.Awk.vals.to(kw["dtype"])
            layout = sub.Awk.layout
        else:
            cols = vals = None
            layout = "gather"
        gtw = torch.full((nwcon,), float(gamma_scalar_sparse), **kw)
        idxw = torch.arange(nwcon, device=self.device)
        gsw = torch.where(idxw < self.problem.nwinequality, 0.0, gtw)
        return ProblemData(
            g=torch.zeros(n, **kw), A=torch.zeros((ncon, n), **kw),
            c=torch.zeros(ncon, **kw), cw=torch.zeros(nwcon, **kw),
            lb=sub.lk.to(**kw), ub=sub.uk.to(**kw),
            lb_mask=ones, ub_mask=ones,
            gamma_s=gamma_s.to(**kw), gamma_t=gamma_t.to(**kw),
            gamma_sw=gsw, gamma_tw=gtw,
            Aw_cols=cols, Aw_vals=vals, nwblock=sub.nwblock,
            Aw_layout=layout)

    def _qp_params(self, obj_scale=1.0, ck_override=None) -> QPParams:
        sub = self.subproblem
        kw = dict(dtype=self.ip.dtype, device=self.device)
        qn = self.qn_holder.get("state")
        if qn is not None:
            b0, Z, M = qnmod.qn_compact(qn)
        else:
            b0, Z, M = torch.tensor(1.0, **kw), None, None
        nwcon = sub.nwcon
        ck = sub.ck if ck_override is None else ck_override
        return QPParams(
            fk=sub.fk.to(**kw), gk=sub.gk.to(**kw), ck=ck.to(**kw),
            Ak=sub.Ak.to(**kw),
            cwk=sub.cwk.to(**kw) if nwcon > 0 else torch.zeros(0, **kw),
            Aw_cols=sub.Awk.cols if nwcon > 0 else None,
            Aw_vals=sub.Awk.vals.to(**kw) if nwcon > 0 else None,
            b0=b0, Z=Z, M=M, obj_scale=torch.tensor(obj_scale, **kw))

    def _init_ip_qn(self):
        o = self.options
        qt = o["qn_type"]
        msub = qnmod.resolve_subspace_size(
            o["qn_subspace_size"], o["qn_subspace_auto"],
            self.problem.nvars, self.ip.dtype)
        if qt != "none" and msub > 0:
            from .ip import _resolve_qn_storage
            self.qn_holder["state"] = qnmod.qn_init(
                msub, self.problem.nvars, dtype=self.ip.dtype, qn_type=qt,
                storage_dtype=_resolve_qn_storage(o["qn_storage_dtype"],
                                                  self.ip.dtype),
                update_type=o["qn_update_type"], diag_type=o["qn_diag_type"],
                device=self.device)
        else:
            self.qn_holder["state"] = None

    # -- shared helpers ------------------------------------------------------

    def _viol_array(self, c) -> np.ndarray:
        return self.syncs.array(_viol(c, self.problem.ninequality))

    def _model_infeas(self, c, gamma=None) -> float:
        return self.syncs.value(
            _l1_violation(c, self.problem.ninequality, gamma))

    def _gamma(self) -> torch.Tensor:
        return torch.as_tensor(self.penalty_gamma, device=self.device)

    def compute_kkt_error(self, z, zw) -> Tuple[float, float]:
        """Projected-gradient KKT error with bound-activity masking
        (`computeKKTError`, `ParOptTrustRegion.cpp:2391-2470`)."""
        relax = self.options["tr_bound_relax"]
        s = self.subproblem
        r = s.gk - matmul(s.Ak.T, z) if s.ncon else s.gk
        if s.nwcon > 0:
            r = r - s.Awk.rmatvec(zw)
        x, lb, ub = s.xk, s.lb, s.ub
        r = torch.where((x <= lb + relax) & (r > 0.0), 0.0, r)
        r = torch.where((x >= ub - relax) & (r < 0.0), 0.0, r)
        zero = torch.zeros((), dtype=r.dtype, device=r.device)

        def amax(a):
            return torch.max(torch.abs(a)) if a.numel() else zero

        # every scalar in one read; an absent multiplier block counts 0
        l1, linf, zm, zwm, g_l1, g_inf = self.syncs.values(
            torch.sum(torch.abs(r)), amax(r),
            amax(z) if s.ncon else zero, amax(zw) if s.nwcon else zero,
            torch.sum(torch.abs(s.gk)), amax(s.gk))
        zmax = max(1.0, zm, zwm)
        return l1 / max(g_l1, zmax), linf / max(g_inf, zmax)

    def _solve_subproblem(self, ck_override=None):
        if self._custom_sub:
            self.ip.reset_design_and_bounds()
            self.ip.set_penalty_gamma(self.penalty_gamma)
            self.ip.optimize()
            self.subproblem_iters = self.ip.niter
            self.inner_iters += self.ip.niter
            step, z, zw, _, _ = self.ip.get_optimized_point()
            return step, z, zw
        if self._fused_qp is None:
            self._build_fused()
        dt = self.ip.dtype
        gam = torch.as_tensor(self.penalty_gamma, dtype=dt,
                              device=self.device)
        idx = torch.arange(self.problem.ncon, device=self.device)
        gamma_s = torch.where(idx < self.problem.ninequality, 0.0, gam)
        data = self._fused_data(gamma_s, gam, self.options["penalty_gamma"])
        params = self._qp_params(ck_override=ck_override)
        p0 = 0.5 * (self.subproblem.lk + self.subproblem.uk)
        st = self._fused_qp.solve(p0.to(dt), data, params,
                                  compact=(params.b0, params.Z, params.M))
        self.subproblem_iters = int(self.syncs.value(st.k))
        self.inner_iters += self.subproblem_iters
        return st.vars.x, st.vars.z, st.vars.zw

    def _minimize_infeas(self):
        """Steering / restoration infeasibility solve (`minimizeInfeas`,
        `ParOptTrustRegion.cpp:1107-1229`). Returns (step, best_con_infeas):
        unit elastic penalties + a tiny objective scale make the IP minimize
        the l1 constraint violation inside the TR box."""
        o = self.options
        gamma_big = max(1e6, 1e2 * o["tr_penalty_gamma_max"])
        if self._custom_sub:
            qn_obj = self.qn_holder.get("state")
            if hasattr(qn_obj, "use_quasi_newton_objective"):
                qn_obj.use_quasi_newton_objective = False
            self.infeas_problem.obj_scale = 1.0 / gamma_big
            self.ip_infeas.set_quasi_newton_holder(self.qn_holder)
            self.ip_infeas.reset_design_and_bounds()
            self.ip_infeas.optimize()
            self.inner_iters += self.ip_infeas.niter
            step, _, _, _, _ = self.ip_infeas.get_optimized_point()
            if hasattr(qn_obj, "use_quasi_newton_objective"):
                qn_obj.use_quasi_newton_objective = True
        else:
            if self._fused_infeas is None:
                self._build_fused()
            dt = self.ip.dtype
            ones = torch.ones(self.problem.ncon, dtype=dt,
                              device=self.device)
            idx = torch.arange(self.problem.ncon, device=self.device)
            gamma_s = torch.where(idx < self.problem.ninequality, 0.0, ones)
            data = self._fused_data(gamma_s, ones, 1.0)
            params = self._qp_params(obj_scale=1.0 / gamma_big)
            compact = ((params.b0, params.Z, params.M)
                       if o["tr_adaptive_objective"] == "subproblem_objective"
                       else None)
            p0 = 0.5 * (self.subproblem.lk + self.subproblem.uk)
            st = self._fused_infeas.solve(p0.to(dt), data, params,
                                          compact=compact)
            self.inner_iters += int(self.syncs.value(st.k))
            step = st.vars.x
        _, c_best = self.subproblem.model_obj_con(step)
        return step, self._viol_array(c_best)

    # -- main entry ----------------------------------------------------------

    def optimize(self) -> Dict[str, Any]:
        o = self.options
        self._logger = TRLogger(o["tr_output_file"])
        if o["tr_accept_step_strategy"] == "filter_method":
            result = self._filter_optimize()
        else:
            result = self._sl1qp_optimize()
        self._logger.close()
        return result

    def get_optimized_point(self):
        return self.subproblem.xk

    def _result(self, converged, infeas, l1, linf) -> Dict[str, Any]:
        return {"x": self.subproblem.xk,
                "fobj": self.syncs.value(self.subproblem.fk),
                "converged": converged, "niter": self.iter_count,
                "infeas": infeas, "l1": l1, "linfty": linf}

    def _z_stats(self, z):
        """(avg |z|, max |z|) of the dense multipliers for the log."""
        if not self.problem.ncon:
            return 0.0, 0.0
        zabs = np.abs(self.syncs.array(z))
        return float(np.sum(zabs)) / self.problem.ncon, float(np.max(zabs))

    def _pen_stats(self):
        if not self.problem.ncon:
            return 0.0, 0.0
        return (float(np.mean(self.penalty_gamma)),
                float(np.max(self.penalty_gamma)))

    # -- SL1QP ---------------------------------------------------------------

    def _sl1qp_optimize(self) -> Dict[str, Any]:
        o = self.options
        adaptive = o["tr_adaptive_gamma_update"]
        infeas_tol = o["tr_infeas_tol"]
        l1_tol, linf_tol = o["tr_l1_tol"], o["tr_linfty_tol"]
        gamma_max = o["tr_penalty_gamma_max"]
        gamma_min = o["tr_penalty_gamma_min"]
        write_freq = o["tr_write_output_frequency"]

        self.subproblem.init_model(self.tr_size)
        converged = False
        infeas = l1 = linf = float("inf")

        for i in range(o["tr_max_iterations"]):
            best_con_infeas = None
            if adaptive:
                _, best_con_infeas = self._minimize_infeas()

            if write_freq > 0 and i % write_freq == 0:
                self.problem.write_output(i, self.subproblem.xk)

            step, z, zw = self._solve_subproblem()

            if adaptive:
                _, c0 = self.subproblem.model_obj_con(None)
                _, cm = self.subproblem.model_obj_con(step)
                con_infeas = self._viol_array(c0)
                model_con_infeas = self._viol_array(cm)

            infeas, l1, linf, rho = self._sl1qp_update(step, z, zw)

            if infeas < infeas_tol and (l1 < l1_tol or linf < linf_tol):
                converged = True
                break

            if adaptive:
                # per-constraint penalty adaptation
                # (`ParOptTrustRegion.cpp:1609-1671`)
                zabs = np.abs(self.syncs.array(z))
                for j in range(self.problem.ncon):
                    infeas_reduction = con_infeas[j] - model_con_infeas[j]
                    best_reduction = con_infeas[j] - best_con_infeas[j]
                    if (zabs[j] > infeas_tol and con_infeas[j] < infeas_tol
                            and self.penalty_gamma[j] >= 2.0 * zabs[j]):
                        self.penalty_gamma[j] = max(
                            0.5 * (self.penalty_gamma[j] + zabs[j]),
                            gamma_min)
                    elif (con_infeas[j] > infeas_tol
                          and 0.995 * best_reduction > infeas_reduction):
                        self.penalty_gamma[j] = min(
                            1.5 * self.penalty_gamma[j], gamma_max)

        return self._result(converged, infeas, l1, linf)

    def _sl1qp_update(self, step, z, zw):
        """Accept/reject + radius update (`sl1qpUpdate`,
        `ParOptTrustRegion.cpp:1231-1452`)."""
        o = self.options
        t0 = time.time()
        tr_min, tr_max = o["tr_min_size"], o["tr_max_size"]
        fprec = o["function_precision"]
        gam = self._gamma()
        nineq = self.problem.ninequality

        fk, ck = self.subproblem.model_obj_con(None)
        ft_model, ct_model = self.subproblem.model_obj_con(step)
        infeas_k_t = _l1_violation(ck, nineq, gam)
        infeas_model_t = _l1_violation(ct_model, nineq, gam)
        ft, ct = self.subproblem.eval_trial_step_and_update(
            True, step, z, zw)
        (infeas_k, obj_reduc, infeas_model, f_reduc, infeas_t,
         infeas_new) = self.syncs.values(
            infeas_k_t, fk - ft_model, infeas_model_t, fk - ft,
            _l1_violation(ct, nineq, gam), _l1_violation(ct, nineq))

        actual_reduc = f_reduc + (infeas_k - infeas_t)
        model_reduc = obj_reduc + (infeas_k - infeas_model)

        if abs(model_reduc) <= fprec and abs(actual_reduc) <= fprec:
            rho = 1.0
        else:
            rho = actual_reduc / model_reduc if model_reduc != 0 else 1.0

        if self._logger is not None and o["output_level"] > 0:
            # actual/predicted reduction block, the contract
            # `unpack_tr_2nd_output` parses (`ParOptTrustRegion.cpp:
            # 1316-1321`)
            self._logger.write(
                "\n%-15s %12s %12s %12s %12s\n"
                % ("Model", "ared(f)", "pred(f)", "ared(c)", "pred(c)"))
            self._logger.write(
                "%15s %12.5e %12.5e %12.5e %12.5e\n"
                % (" ", f_reduc, obj_reduc, infeas_k - infeas_t,
                   infeas_k - infeas_model))

        accepted = rho >= o["tr_eta"] or self.tr_size <= tr_min
        if accepted:
            smax = (self.syncs.value(torch.max(torch.abs(step)))
                    if step.numel() else 0.0)
            try:
                self.subproblem.accept_trial_step(step, z, zw)
            except TypeError:
                self.subproblem.accept_trial_step(step)
        else:
            self.subproblem.reject_trial_step()
            smax = 0.0

        if rho < 0.25:
            self.tr_size = max(0.25 * self.tr_size, tr_min)
        elif rho > 0.75:
            self.tr_size = min(1.5 * self.tr_size, tr_max)
        self.subproblem.set_trust_region_bounds(self.tr_size)

        l1, linf = self.compute_kkt_error(z, zw)
        skipped, damped = self.subproblem.qn_update_type
        info = ("dampH " if damped else "") + ("skipH " if skipped else "")
        info += f"{self.subproblem_iters} "
        if not accepted:
            info += "rej "
        self._logger.log(self.iter_count, self.syncs.value(fk), infeas_new,
                         l1, linf, smax, self.tr_size, rho, model_reduc,
                         *self._z_stats(z), *self._pen_stats(),
                         time.time() - t0, info)
        self.iter_count += 1
        return infeas_new, l1, linf, rho

    # -- filter method -------------------------------------------------------

    def _acceptable_by_pair(self, f_new, h_new, f_old, h_old) -> bool:
        o = self.options
        gamma = o["filter_gamma"]
        if o["filter_sufficient_reduction"]:
            return (h_new < (1.0 - gamma) * h_old
                    or f_new < f_old - gamma * h_new)
        return h_new < h_old or f_new < f_old

    def _acceptable_by_filter(self, f, h) -> bool:
        return all(self._acceptable_by_pair(f, h, fe, he)
                   for fe, he in self.filter)

    def _add_to_filter(self, f, h):
        self.filter = [(fe, he) for fe, he in self.filter
                       if not (f <= fe and h <= he)]
        self.filter.append((f, h))

    def _is_accepted_by_soc(self, step, ft, ct):
        """Second-order-correction loop (`isAcceptedBySoc`,
        `ParOptTrustRegion.cpp:2228-2355`): re-solve the QP with the
        constraint linearization shifted to reproduce the rejected trial
        values; accept when filter-acceptable.  Returns
        (success, step, ft, ct, niters)."""
        o = self.options
        infeas_tol = o["tr_infeas_tol"]
        nineq = self.problem.ninequality
        gam = self._gamma()

        def merit_and_infeas(f, c):
            h, pen = self.syncs.values(_l1_violation(c, nineq),
                                       _l1_violation(c, nineq, gam))
            return float(f) + pen, h

        best_step, best_ft, best_ct = step, ft, ct
        merit_old, infeas_old = merit_and_infeas(ft, ct)
        niters = 0
        for _ in range(o["tr_max_soc_iterations"]):
            c_soc = ct - (self.subproblem.Ak @ step if self.problem.ncon
                          else ct)
            step, z, zw = self._solve_subproblem(ck_override=c_soc)
            ft, ct = self.subproblem.eval_trial_step_and_update(
                bool(o["tr_soc_update_qn"]), step, z, zw)
            ft = self.syncs.value(ft)
            niters += 1
            merit_new, infeas_new = merit_and_infeas(ft, ct)
            r = infeas_new / max(infeas_old, 1e-300)
            infeas_old = infeas_new
            if merit_new < merit_old:
                best_step, best_ft, best_ct = step, ft, ct
                merit_old = merit_new
            zabs = (np.abs(self.syncs.array(z)) if self.problem.ncon
                    else np.zeros(0))
            infeas_qp = bool(
                (zabs + infeas_tol >= np.asarray(self.penalty_gamma)).any())
            if self._acceptable_by_filter(ft, infeas_new):
                self._add_to_filter(ft, infeas_new)
                return True, step, ft, ct, niters
            if infeas_qp or r > 0.25 or infeas_new < infeas_tol:
                return False, best_step, best_ft, best_ct, niters
        return False, best_step, best_ft, best_ct, niters

    def _filter_optimize(self) -> Dict[str, Any]:
        o = self.options
        eta = o["tr_eta"]
        tr_min, tr_max = o["tr_min_size"], o["tr_max_size"]
        infeas_tol = o["tr_infeas_tol"]
        l1_tol, linf_tol = o["tr_l1_tol"], o["tr_linfty_tol"]
        has_restore = o["filter_has_feas_restore_phase"]
        write_freq = o["tr_write_output_frequency"]

        self.subproblem.init_model(self.tr_size)
        _, c0 = self.subproblem.model_obj_con(None)
        h0 = self._model_infeas(c0)
        self.filter = []
        self._add_to_filter(-1e20, max(1e4, 1.25 * h0))

        last_resto = False
        converged = False
        infeas_trial = l1 = linf = float("inf")

        for it in range(o["tr_max_iterations"]):
            t0 = time.time()
            fk_t, ck = self.subproblem.model_obj_con(None)
            fk, hk = self.syncs.values(
                fk_t, _l1_violation(ck, self.problem.ninequality))

            step, z, zw = self._solve_subproblem()

            this_resto = False
            if has_restore:
                _, cm = self.subproblem.model_obj_con(step)
                if self._model_infeas(cm) > infeas_tol:
                    this_resto = True
                    self._add_to_filter(fk, hk)
                elif last_resto and self.qn_holder["state"] is not None:
                    self.qn_holder["state"] = qnmod.qn_reset(
                        self.qn_holder["state"])

            if this_resto:
                if not last_resto and self.qn_holder["state"] is not None:
                    self.qn_holder["state"] = qnmod.qn_reset(
                        self.qn_holder["state"])
                step, _ = self._minimize_infeas()

            fobj_model, _ = self.subproblem.model_obj_con(step)
            ft_t, ct = self.subproblem.eval_trial_step_and_update(
                True, step, z, zw)
            zero = torch.zeros((), dtype=step.dtype, device=step.device)
            ft, infeas_trial, fobj_model, smax = self.syncs.values(
                ft_t, _l1_violation(ct, self.problem.ninequality),
                fobj_model,
                torch.max(torch.abs(step)) if step.numel() else zero)

            init_tr = increase_tr = decrease_tr = False
            accepted = False
            info_rej = ""
            model_red = fk - fobj_model
            actual_red = fk - ft
            rho = actual_red / model_red if model_red != 0 else 1.0

            if this_resto:
                self.subproblem.accept_trial_step(step)
                accepted = True
                if smax >= 0.99 * self.tr_size:
                    increase_tr = True
            else:
                by_filter = self._acceptable_by_filter(ft, infeas_trial)
                by_pair = self._acceptable_by_pair(ft, infeas_trial, fk, hk)
                if by_filter and by_pair:
                    if actual_red < eta * model_red and model_red > 0.0:
                        self.subproblem.reject_trial_step()
                        smax = 0.0
                        decrease_tr = True
                        info_rej = "rej:rho"
                    else:
                        self.subproblem.accept_trial_step(step)
                        accepted = True
                        if model_red <= 0.0:
                            self._add_to_filter(ft, infeas_trial)
                        init_tr = True
                elif self.tr_size <= tr_min:
                    self.subproblem.accept_trial_step(step)
                    accepted = True
                    if smax >= 0.99 * self.tr_size:
                        increase_tr = True
                elif o["tr_use_soc"]:
                    ok, step, ft, ct, _ = self._is_accepted_by_soc(step, ft,
                                                                   ct)
                    infeas_trial = self._model_infeas(ct)
                    smax = (self.syncs.value(torch.max(torch.abs(step)))
                            if ok else 0.0)
                    if ok:
                        self.subproblem.accept_trial_step(step)
                        accepted = True
                        if smax >= 0.99 * self.tr_size:
                            increase_tr = True
                        info_rej = "SocSucc"
                    else:
                        self.subproblem.reject_trial_step()
                        decrease_tr = True
                        info_rej = "SocFail"
                else:
                    self.subproblem.reject_trial_step()
                    smax = 0.0
                    decrease_tr = True
                    info_rej = "rej:" + ("F" if not by_filter else "") + (
                        "xk" if not by_pair else "")

            if write_freq > 0 and it % write_freq == 0:
                self.problem.write_output(it, self.subproblem.xk)

            l1, linf = self.compute_kkt_error(z, zw)

            skipped, damped = self.subproblem.qn_update_type
            info = ("dampH " if damped else "") + ("skipH " if skipped else "")
            info += f"{self.subproblem_iters} f{len(self.filter)} "
            if this_resto:
                info += "R "
            if not accepted:
                info += info_rej or "rej"
            self._logger.log(self.iter_count, ft, infeas_trial, l1, linf,
                             smax, self.tr_size, rho, model_red,
                             *self._z_stats(z), *self._pen_stats(),
                             time.time() - t0, info)
            self.iter_count += 1

            if increase_tr:
                self.tr_size = min(2.0 * self.tr_size, tr_max)
            elif decrease_tr:
                self.tr_size = max(0.5 * self.tr_size, tr_min)
            if init_tr:
                self.tr_size = tr_max
            self.subproblem.set_trust_region_bounds(self.tr_size)
            last_resto = this_resto

            if infeas_trial < infeas_tol and (l1 < l1_tol or linf < linf_tol):
                converged = True
                break

        return self._result(converged, infeas_trial, l1, linf)


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


@pytree
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


class _TRHead(NamedTuple):
    """An outer TR iteration up to its inner solves."""
    lk: torch.Tensor         # the trust-region box about xk
    uk: torch.Tensor
    p0: torch.Tensor         # the inner solves' start
    params: QPParams         # the QP model (its sparse pattern left out)
    gamma_s: torch.Tensor    # the QP solve's elastic penalties
    gamma_t: torch.Tensor


def _tr_head(to: FusedTROptions, lbv, ubv, state: FusedTRState) -> _TRHead:
    """The trust-region bounds and the QP model of an outer iteration."""
    xk = state.xk
    zero = torch.zeros((), dtype=xk.dtype, device=xk.device)
    ncon = state.ck.shape[0]
    idx = torch.arange(ncon, device=xk.device)
    # -- trust-region bounds (`initModelAndBounds`/`setTrustRegionBounds`) --
    lk = torch.maximum(-state.tr_size, lbv - xk)
    uk = torch.minimum(state.tr_size, ubv - xk)
    # compact quasi-Newton pieces of the QP objective
    if state.qn is not None:
        b0, Z, M = qnmod.qn_compact(state.qn)
    else:
        b0, Z, M = zero + 1.0, None, None
    params = QPParams(fk=state.fk, gk=state.gk, ck=state.ck, Ak=state.Ak,
                      cwk=state.cwk, Aw_cols=None, Aw_vals=None, b0=b0, Z=Z,
                      M=M, obj_scale=zero + 1.0)
    return _TRHead(lk=lk, uk=uk, p0=0.5 * (lk + uk), params=params,
                   gamma_s=torch.where(idx < to.ninequality, 0.0,
                                       state.gamma),
                   gamma_t=state.gamma)


def _tr_rho(to: FusedTROptions, gamma, fk, fm, ft, ck, cm, ct):
    """rho, the actual over the model reduction of the l1 merit
    f + Σ γ·viol(c) (`sl1qpUpdate`): (fm, cm) the model's values at the
    step, (ft, ct) the trial's; 1 when both reductions are within the
    function precision or the model predicts none."""
    nineq = to.ninequality
    infeas_k = torch.sum(gamma * _viol(ck, nineq))
    actual_reduc = (fk - ft) + (infeas_k - torch.sum(gamma * _viol(ct, nineq)))
    model_reduc = (fk - fm) + (infeas_k
                               - torch.sum(gamma * _viol(cm, nineq)))
    fprec = to.function_precision
    both_tiny = ((torch.abs(model_reduc) <= fprec)
                 & (torch.abs(actual_reduc) <= fprec))
    return torch.where(both_tiny | (model_reduc == 0.0), 1.0,
                       actual_reduc / torch.where(model_reduc == 0.0, 1.0,
                                                  model_reduc))


def _tr_radius(to: FusedTROptions, tr_size, rho, trial_finite):
    """(accepted, the next radius) (`:1353-1372`): a trial is accepted at
    rho >= eta, or when finite at the smallest radius."""
    accepted = ((rho >= to.eta)
                | ((tr_size <= to.tr_min) & trial_finite))
    tr_n = torch.where(rho < 0.25, torch.clamp(0.25 * tr_size, min=to.tr_min),
                       torch.where(rho > 0.75,
                                   torch.clamp(1.5 * tr_size, max=to.tr_max),
                                   tr_size))
    return accepted, tr_n


def _tr_penalties(to: FusedTROptions, gamma, z, ck, cm, best_con_infeas):
    """The adaptive per-constraint penalties (`:1609-1671`): shrink toward
    |z| where a row is feasible, grow where the QP step reduced its
    violation less than the steering step could."""
    nineq = to.ninequality
    zabs = torch.abs(z)
    con_infeas = _viol(ck, nineq)
    infeas_reduction = con_infeas - _viol(cm, nineq)
    best_reduction = con_infeas - best_con_infeas
    shrink = ((zabs > to.infeas_tol) & (con_infeas < to.infeas_tol)
              & (gamma >= 2.0 * zabs))
    grow = ((con_infeas > to.infeas_tol)
            & (0.995 * best_reduction > infeas_reduction))
    return torch.where(
        shrink, torch.clamp(0.5 * (gamma + zabs), min=to.gamma_min),
        torch.where(grow, torch.clamp(1.5 * gamma, max=to.gamma_max),
                    gamma))


def _tr_kkt(to: FusedTROptions, lbv, ubv, xk, gk, r, zmax, ct):
    """(l1, linf, infeasibility, converged) at the post-update point
    (`computeKKTError`, `ParOptTrustRegion.cpp:2391-2470`): r is the
    Lagrangian gradient, zeroed where a bound is active, and the norms are
    scaled by max(‖gk‖, zmax)."""
    relax = to.bound_relax
    r = torch.where((xk <= lbv + relax) & (r > 0.0), 0.0, r)
    r = torch.where((xk >= ubv - relax) & (r < 0.0), 0.0, r)
    l1_raw = torch.sum(torch.abs(r))
    linf_raw = torch.max(torch.abs(r)) if r.numel() else torch.zeros_like(
        l1_raw)
    l1 = l1_raw / torch.maximum(torch.sum(torch.abs(gk)), zmax)
    linf = linf_raw / torch.maximum(torch.max(torch.abs(gk)), zmax)
    infeas = torch.sum(_viol(ct, to.ninequality))
    converged = ((infeas < to.infeas_tol)
                 & ((l1 < to.l1_tol) | (linf < to.linf_tol)))
    return l1, linf, infeas, converged


def _tr_tail(user_model: ModelFns, to: FusedTROptions, lbv, ubv,
             d_tmpl: ProblemData, params_user, state: FusedTRState,
             head: _TRHead, p_inf, inf_iters, p, z, zw,
             qp_iters) -> FusedTRState:
    """The outer iteration after its inner solves: the model reductions,
    the trial evaluation and QN update, acceptance and the radius, the
    penalties and the KKT error (`sl1qpUpdate`)."""
    xk, fk, ck, gk, Ak, cwk = (state.xk, state.fk, state.ck, state.gk,
                               state.Ak, state.cwk)
    zero = torch.zeros((), dtype=xk.dtype, device=xk.device)
    ncon = ck.shape[0]
    nwcon = d_tmpl.nwcon
    if p_inf is not None:
        c_best = (ck + Ak @ p_inf) if ncon else ck
        best_con_infeas = _viol(c_best, to.ninequality)
    else:
        best_con_infeas = torch.zeros_like(ck)

    # -- the model at the step (`sl1qpUpdate`) -------------------------------
    cm = (ck + Ak @ p) if ncon else ck
    fm = fk + torch.dot(gk, p)
    if state.qn is not None:
        fm = fm + 0.5 * torch.dot(p, _qp_Bp(head.params, p))

    # -- trial evaluation + quasi-Newton update (`evalTrialStepAndUpdate`,
    #    update_flag=True: the QN updates on the trial REGARDLESS of
    #    acceptance, `ParOptTrustRegion.cpp:172-212`) ------------------------
    xt = xk + p
    with span("paropt.tr.eval"):
        ft, ct, cwt = user_model.eval_obj_con(params_user, xt)
        gt, At = user_model.eval_grad(params_user, xt)
    # fail-stop on non-finite trial data: a NaN/Inf trial is never
    # accepted, never reaches the QN state, and shrinks the radius
    trial_finite = (torch.isfinite(ft) & torch.all(torch.isfinite(ct))
                    & torch.all(torch.isfinite(gt))
                    & torch.all(torch.isfinite(p)))
    qn_new = state.qn
    if state.qn is not None:
        with span("paropt.tr.qn_update"):
            # y = grad_x L(xt, z) - grad_x L(xk, z); the CONSTANT sparse
            # Jacobian's Aw^T zw term is identical at both points and
            # cancels, so it is not formed
            if ncon:
                y = (gt - At.T @ z) - (gk - Ak.T @ z)
            else:
                y = gt - gk
            qn_new, _, _ = qnmod.qn_update(state.qn, p, y,
                                           accept=trial_finite)

    rho = _tr_rho(to, state.gamma, fk, fm, ft, ck, cm, ct)
    # a non-finite trial counts as maximal disagreement: reject + shrink
    rho = torch.where(trial_finite, rho, -float("inf"))

    # -- accept / reject + radius update -------------------------------------
    accepted, tr_n = _tr_radius(to, state.tr_size, rho, trial_finite)

    def sel(a, b):
        return torch.where(accepted, a, b)

    xk_n, fk_n, ck_n = sel(xt, xk), sel(ft, fk), sel(ct, ck)
    gk_n, Ak_n = sel(gt, gk), sel(At, Ak)
    # cw at the accepted point comes from the trial evaluation
    cwk_n = sel(cwt, cwk) if nwcon > 0 else cwk

    gamma_n = state.gamma
    if to.adaptive_gamma and ncon:
        gamma_n = _tr_penalties(to, gamma_n, z, ck, cm, best_con_infeas)

    # -- KKT error at the post-update point ----------------------------------
    r = gk_n - Ak_n.T @ z if ncon else gk_n
    if nwcon > 0:
        r = r - d_tmpl.Aw_rmatvec(zw)
    zmax = zero + 1.0
    if ncon:
        zmax = torch.maximum(zmax, torch.max(torch.abs(z)))
    if nwcon:
        zmax = torch.maximum(zmax, torch.max(torch.abs(zw)))
    l1, linf, infeas_new, converged = _tr_kkt(to, lbv, ubv, xk_n, gk_n, r,
                                              zmax, ct)

    return FusedTRState(
        xk=xk_n, fk=fk_n, ck=ck_n, gk=gk_n, Ak=Ak_n, cwk=cwk_n, qn=qn_new,
        tr_size=tr_n, gamma=gamma_n, k=state.k + 1,
        subiters=state.subiters + qp_iters + inf_iters, converged=converged,
        infeas=infeas_new, l1=l1, linf=linf, rho=rho)


def _inner_solve(model: ModelFns, opts: FusedIPOptions, R: _Run, x0,
                 d: ProblemData, da, params: QPParams, compact, frozen):
    """One inner IP solve of the TR step (steering or QP); in a batch the
    ``frozen`` instances (already converged) start it converged."""
    pa = params._replace(
        **{f: (None if f in ("Aw_cols", "Aw_vals") else 0)
           for f in QPParams._fields})
    ca = None if compact is None else 0
    st0 = R.call(functools.partial(_fused_init, model, opts),
                 (0, da, pa, None, ca), x0, d, params, None, compact)
    if R.batched:
        st0 = dataclasses.replace(st0, converged=frozen)
    return _fused_solve_loop(model, opts, st0, d, params, compact, R.host,
                             run=R, axes=(da, pa, ca))


def _fused_tr_step(user_model: ModelFns, qp_model: ModelFns,
                   inf_model: ModelFns, qp_opts: FusedIPOptions,
                   inf_opts: FusedIPOptions, to: FusedTROptions,
                   lbv, ubv, d_tmpl: ProblemData, params_user,
                   state: FusedTRState, host=bool,
                   run: Optional[_Run] = None) -> FusedTRState:
    """One SL1QP outer iteration (`sl1qpOptimize` loop body +
    `sl1qpUpdate`, `ParOptTrustRegion.cpp:1544-1671, 1231-1452`).
    ``host`` reads a device flag on the host (the inner solves' reads).  A
    batched ``run`` steps k instances, the inner solves batched."""
    R = run or _Run(host)
    dev = state.xk.device
    kw = dict(dtype=state.xk.dtype, device=dev)
    ncon, nwcon = d_tmpl.ncon, d_tmpl.nwcon
    head = R.call(functools.partial(_tr_head, to, lbv, ubv), (0,), state)
    params = head.params._replace(Aw_cols=d_tmpl.Aw_cols,
                                  Aw_vals=d_tmpl.Aw_vals)
    zero_i = torch.zeros((), dtype=torch.int32, device=dev)
    frozen = state.converged if R.batched else None
    # the instance axes of the inner solves' data: the box is per instance
    none = tmap(lambda _: None, d_tmpl)

    # -- steering infeasibility solve (`minimizeInfeas`) --------------------
    p_inf = None
    inf_iters = zero_i
    if to.adaptive_gamma:
        gamma_big = max(1e6, 1e2 * to.gamma_max)
        inf_params = params._replace(
            obj_scale=torch.full_like(params.obj_scale, 1.0 / gamma_big))
        ones = torch.ones(ncon, **kw)
        ones_w = torch.ones(nwcon, **kw)
        idx = torch.arange(ncon, device=dev)
        d_inf = dataclasses.replace(
            d_tmpl, lb=head.lk, ub=head.uk,
            gamma_s=torch.where(idx < to.ninequality, 0.0, ones),
            gamma_t=ones,
            gamma_sw=torch.where(torch.arange(nwcon, device=dev)
                                 < to.nwinequality, 0.0, ones_w),
            gamma_tw=ones_w)
        with span("paropt.tr.steer"):
            st_inf = _inner_solve(
                inf_model, inf_opts, R, head.p0, d_inf,
                dataclasses.replace(none, lb=0, ub=0), inf_params, None,
                frozen)
        p_inf, inf_iters = st_inf.vars.x, st_inf.k

    # -- QP subproblem solve (IP-on-QP, the hot loop) ------------------------
    d_qp = dataclasses.replace(d_tmpl, lb=head.lk, ub=head.uk,
                               gamma_s=head.gamma_s, gamma_t=head.gamma_t)
    compact = (params.b0, params.Z, params.M)
    with span("paropt.tr.qp"):
        st = _inner_solve(qp_model, qp_opts, R, head.p0, d_qp,
                          dataclasses.replace(none, lb=0, ub=0, gamma_s=0,
                                              gamma_t=0),
                          params, compact, frozen)
    v = st.vars
    return R.call(functools.partial(_tr_tail, user_model, to, lbv, ubv,
                                    d_tmpl, params_user),
                  (0, 0, None if p_inf is None else 0, 0, 0, 0, 0, 0),
                  state, head, p_inf, inf_iters, v.x, v.z, v.zw, st.k)


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
        self._ev, self._gr = ev, gr
        self._problem = problem
        self._write_freq = o["tr_write_output_frequency"]
        self._step = functools.partial(
            _fused_tr_step, user_model, qp_model, inf_model, qp_opts,
            inf_opts, to, lbv, ubv, d_tmpl, (), host=self.syncs)

    def solve(self, state0: Optional[FusedTRState] = None,
              jit_loop: bool = True, chunk="auto", checkpoint_path=None):
        """Run the outer loop (paropt_tpu/tr.py:1383-1417); returns (result
        dict, final state).  Pass a previous final state to resume.
        ``jit_loop`` / ``chunk`` as in `FusedMMA.solve`: by default the
        loop stops at the absolute count ``tr_max_iterations``, in windows
        sized by ``'auto'``; ``jit_loop=False`` runs ``tr_max_iterations``
        more outer iterations from the state given.  Nothing is compiled:
        the final state is the same under any chunk.  The problem's
        ``write_output(it, x)`` hook fires every
        ``tr_write_output_frequency`` outer iterations at window
        boundaries, and ``checkpoint_path`` gets the full state at the same
        cadence (`utils.checkpoint`)."""
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
        """k multi-start solves as one (paropt_tpu/tr.py:1419-1455): each
        instance's initial linearization (f, c, cw, g, A at its x0) is
        built under ``torch.func.vmap``, and so are the outer step's phases
        and its inner solves; one host read of "every instance converged"
        per outer iteration, and an instance that has converged keeps its
        state bit for bit while the others iterate.

        ``x0_batch``: [k, n] starting points.  ``chunk``: the windows of
        `utils.chunked.run_chunked_batched` (an int, ``'auto'`` or None);
        the result is the same under any.  Returns (results, states):
        ``results`` holds per-instance numpy arrays of fobj, converged,
        niter, infeas, l1 and linfty (and x [k, n]); ``states`` is the
        `FusedTRState` with a leading k axis."""
        from .utils.chunked import (batch_reader, run_chunked_batched,
                                    step_until)
        run = _Run(self.syncs, batched=True)
        s0 = self._state0
        x0_batch = torch.as_tensor(x0_batch, dtype=s0.xk.dtype,
                                   device=s0.xk.device)

        def start(st, x):
            f0, c0, cw0 = self._ev((), x)
            g0, A0 = self._gr((), x)
            return dataclasses.replace(st, xk=x, fk=f0, ck=c0, gk=g0, Ak=A0,
                                       cwk=cw0)

        state = run.call(start, (None, 0), s0, x0_batch)

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
