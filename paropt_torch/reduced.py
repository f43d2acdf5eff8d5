"""Reduced problems: optimize over a subset of the design variables
(counterpart of paropt_tpu/reduced.py; the reference's pattern is
`examples/reduced_problem/reduced.py:62-116`).

`ReducedProblem` wraps a problem, fixes a chosen subset of its design
variables at given values, and presents the free ones as a smaller problem
to any optimizer: design freezes, non-design regions, continuation.  The
expansion free -> full is a scatter (``index_copy``) into a full-size
template that holds the fixed values, in the wrapped problem's dtype and on
its device, so autodiff flows through it to the free subset.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .problem import Problem

__all__ = ["ReducedProblem"]


class ReducedProblem(Problem):
    """``problem`` restricted to its non-fixed design variables.

    ``fixed_idx``: indices (into the full design vector) of the variables
    to fix; ``fixed_vals``: their values.  The dtype and device are those
    of the wrapped problem's starting point.  Sparse (``nwcon``)
    constraints are not supported: fixing variables can break the
    separable partition the sparse path relies on."""

    def __init__(self, problem: Problem, fixed_idx: Sequence[int],
                 fixed_vals: Sequence[float]):
        if problem.nwcon:
            raise ValueError(
                "ReducedProblem does not support sparse (nwcon) constraints")
        fixed_idx = np.asarray(fixed_idx, dtype=np.int64)
        fixed_vals = np.asarray(fixed_vals, dtype=np.float64)
        if fixed_idx.shape != fixed_vals.shape:
            raise ValueError("fixed_idx and fixed_vals length mismatch")
        if fixed_idx.size != np.unique(fixed_idx).size:
            raise ValueError("fixed_idx contains duplicates")
        mask = np.zeros(problem.nvars, dtype=bool)
        mask[fixed_idx] = True
        x0, _, _ = problem.get_vars_and_bounds()
        x0 = torch.as_tensor(x0)
        dev = x0.device
        self.problem = problem
        self.fixed_idx = torch.as_tensor(fixed_idx, device=dev)
        self.free_idx = torch.as_tensor(np.nonzero(~mask)[0], device=dev)
        self._template = torch.zeros(
            problem.nvars, dtype=x0.dtype, device=dev).index_copy(
                0, self.fixed_idx,
                torch.as_tensor(fixed_vals, dtype=x0.dtype, device=dev))
        super().__init__(nvars=int(self.free_idx.shape[0]),
                         ncon=problem.ncon,
                         ninequality=problem.ninequality)

    # -- expansion -----------------------------------------------------------
    def expand(self, x):
        """Full-size design vector with the fixed values filled in."""
        return self._template.index_copy(
            0, self.free_idx, torch.as_tensor(x).to(self._template.dtype))

    def restrict(self, xfull):
        """Free components of a full-size vector."""
        return torch.as_tensor(xfull)[..., self.free_idx]

    # -- Problem surface (delegates to the wrapped problem) ------------------
    def objective(self, x):
        return self.problem.objective(self.expand(x))

    def constraints(self, x):
        return self.problem.constraints(self.expand(x))

    def get_vars_and_bounds(self):
        x0, lb, ub = self.problem.get_vars_and_bounds()
        return self.restrict(x0), self.restrict(lb), self.restrict(ub)

    def eval_obj_con(self, x):
        return self.problem.eval_obj_con(self.expand(x))

    def eval_obj_con_gradient(self, x):
        g, A = self.problem.eval_obj_con_gradient(self.expand(x))
        return self.restrict(g), self.restrict(A)

    def eval_hvec_product(self, x, z, zw, px):
        # lift the free-space direction with ZERO in the fixed slots (the
        # fixed coordinates do not move), then restrict the product
        pfull = torch.zeros_like(self._template).index_copy(
            0, self.free_idx, torch.as_tensor(px).to(self._template.dtype))
        hv = self.problem.eval_hvec_product(self.expand(x), z, zw, pfull)
        return self.restrict(hv)

    def eval_hessian_diag(self, x, z, zw):
        return self.restrict(
            self.problem.eval_hessian_diag(self.expand(x), z, zw))

    def write_output(self, it, x):
        self.problem.write_output(it, self.expand(x))
