"""Problem definition layer (counterpart of paropt_tpu/problem.py).

The user describes

    min  f(x)
    s.t. c(x)  >= 0     (ncon dense global constraints, small)
         cw(x) >= 0     (nwcon separable sparse constraints, may be huge)
         lb <= x <= ub

either with differentiable ``objective(x)`` / ``constraints(x)`` /
``sparse_constraints(x)`` on torch tensors, whose derivatives come from
``torch.func`` (``grad`` for g, ``jacrev`` for the [ncon, n] matrix A,
``jvp``/``vjp`` for the products), or by overriding the ``eval_*`` methods.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

__all__ = ["Problem", "SparseJacobian"]


class SparseJacobian:
    """Structured sparse Jacobian Aw of the separable constraints.

    Each of the ``nwcon`` rows has exactly ``k`` nonzeros, ``cols[i, j]``
    indexing into x with value ``vals[i, j]``.  ``layout`` classifies the
    pattern (`ops.kkt.detect_aw_layout`): for the partition patterns
    ('blocked', 'blocked_t') every product is a reshape."""

    def __init__(self, nvars: int, cols, vals: torch.Tensor,
                 nwblock: int = 1):
        from .ops.kkt import detect_aw_layout
        cols_np = np.asarray(cols)
        if cols_np.ndim != 2:
            raise ValueError("cols must be [nwcon, k]")
        self.nvars = int(nvars)
        self.nwcon, self.k = (int(s) for s in cols_np.shape)
        self.nwblock = int(nwblock)
        if self.nwcon % max(self.nwblock, 1):
            raise ValueError("nwcon must be a multiple of nwblock")
        self.vals = vals
        self.cols = torch.as_tensor(cols_np, dtype=torch.long,
                                    device=vals.device)
        self.layout = detect_aw_layout(cols_np, self.nvars)

    def matvec(self, px: torch.Tensor) -> torch.Tensor:
        """Aw @ px -> [nwcon]."""
        if self.layout == "blocked_t":
            return torch.sum(self.vals.T * px.reshape(self.k, self.nwcon),
                             dim=0)
        if self.layout == "blocked":
            return torch.sum(self.vals * px.reshape(self.nwcon, self.k),
                             dim=1)
        return torch.sum(self.vals * px[self.cols], dim=1)

    def rmatvec(self, zw: torch.Tensor) -> torch.Tensor:
        """Aw^T @ zw -> [nvars]."""
        if self.layout == "blocked_t":
            return (self.vals.T * zw[None, :]).reshape(self.nvars)
        contrib = self.vals * zw[:, None]
        if self.layout == "blocked":
            return contrib.reshape(self.nvars)
        out = torch.zeros(self.nvars, dtype=contrib.dtype,
                          device=contrib.device)
        return out.index_add(0, self.cols.reshape(-1), contrib.reshape(-1))

    def inner_product_blocks(self, c: torch.Tensor) -> torch.Tensor:
        """Blocks of Aw @ diag(c) @ Aw^T -> [nblocks, nwblock, nwblock]."""
        nb = self.nwblock
        if self.layout == "blocked_t":
            cw = c.reshape(self.k, self.nwcon).T
        elif self.layout == "blocked":
            cw = c.reshape(self.nwcon, self.k)
        else:
            cw = c[self.cols]
        if nb == 1:
            return torch.sum(self.vals * self.vals * cw, dim=1).reshape(
                -1, 1, 1)
        nblocks = self.nwcon // nb
        colsb = self.cols.reshape(nblocks, nb, self.k)
        valsb = self.vals.reshape(nblocks, nb, self.k)
        cb = cw.reshape(nblocks, nb, self.k)
        eq = colsb[:, :, None, :, None] == colsb[:, None, :, None, :]
        prod = (valsb * cb)[:, :, None, :, None] * valsb[:, None, :, None, :]
        return torch.sum(torch.where(eq, prod, 0.0), dim=(3, 4))


class Problem:
    """Base problem class.  Subclass and either

    (a) implement differentiable ``objective(x)`` (+ ``constraints(x)`` /
        ``sparse_constraints(x)``) and let ``torch.func`` derive the rest, or
    (b) override the ``eval_*`` methods directly.
    """

    def __init__(self, nvars: int, ncon: int = 0, nwcon: int = 0,
                 nwblock: int = 1, ninequality: Optional[int] = None,
                 nwinequality: Optional[int] = None):
        self.nvars = int(nvars)
        self.ncon = int(ncon)
        self.nwcon = int(nwcon)
        self.nwblock = int(nwblock) if nwcon > 0 else 1
        # by default all constraints are inequalities (ParOptProblem.h:88-113)
        self.ninequality = ncon if ninequality is None else int(ninequality)
        self.nwinequality = (nwcon if nwinequality is None
                             else int(nwinequality))

    # -- (a) differentiable definition --------------------------------------
    def objective(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError("override objective(x)")

    def constraints(self, x: torch.Tensor) -> torch.Tensor:
        """Dense constraints c(x) >= 0, shape [ncon]."""
        raise NotImplementedError("override constraints(x)")

    def sparse_constraints(self, x: torch.Tensor) -> torch.Tensor:
        """Sparse separable constraints cw(x) >= 0, shape [nwcon]."""
        raise NotImplementedError("override sparse_constraints(x)")

    def sparse_jacobian(self, x: torch.Tensor) -> SparseJacobian:
        """Structured Jacobian of ``sparse_constraints`` at x."""
        raise NotImplementedError("override sparse_jacobian(x)")

    # -- (b) evaluation surface (defaults derive from (a)) -------------------
    def get_vars_and_bounds(self):
        """-> (x0, lb, ub), each [nvars]."""
        raise NotImplementedError("override get_vars_and_bounds()")

    def eval_obj_con(self, x) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (fobj, con[ncon])."""
        f = self.objective(x)
        c = (self.constraints(x) if self.ncon > 0
             else x.new_zeros(0))
        return f, c

    def eval_obj_con_gradient(self, x) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (g[n], A[ncon, n])."""
        g = torch.func.grad(self.objective)(x)
        if self.ncon > 0:
            A = torch.func.jacrev(self.constraints)(x)
        else:
            A = x.new_zeros((0, self.nvars))
        return g, A

    def eval_hvec_product(self, x, z, zw, px) -> torch.Tensor:
        """H(x, z, zw) @ px for L = f - z.c - zw.cw."""
        def lag_grad(xv):
            g = torch.func.grad(self.objective)(xv)
            if self.ncon > 0:
                g = g - torch.func.vjp(self.constraints, xv)[1](z)[0]
            if self.nwcon > 0:
                g = g - torch.func.vjp(self.sparse_constraints, xv)[1](zw)[0]
            return g
        return torch.func.jvp(lag_grad, (x,), (px,))[1]

    def eval_hessian_diag(self, x, z, zw) -> torch.Tensor:
        raise NotImplementedError("override eval_hessian_diag(x, z, zw)")

    def eval_sparse_con(self, x) -> torch.Tensor:
        return self.sparse_constraints(x)

    def sparse_jacobian_vec(self, x, px) -> torch.Tensor:
        """Aw(x) @ px."""
        try:
            jac = self.sparse_jacobian(x)
        except NotImplementedError:
            return torch.func.jvp(self.sparse_constraints, (x,), (px,))[1]
        return jac.matvec(px)

    def sparse_jacobian_tvec(self, x, zw) -> torch.Tensor:
        """Aw(x)^T @ zw."""
        try:
            jac = self.sparse_jacobian(x)
        except NotImplementedError:
            return torch.func.vjp(self.sparse_constraints, x)[1](zw)[0]
        return jac.rmatvec(zw)

    def sparse_inner_product(self, x, cvec) -> torch.Tensor:
        """Blocks of Aw @ diag(cvec) @ Aw^T."""
        return self.sparse_jacobian(x).inner_product_blocks(cvec)

    # -- hooks ---------------------------------------------------------------
    def compute_quasi_newton_update_correction(self, x, z, zw, s, y):
        """Hook to modify the (s, y) pair before a QN update."""
        return s, y

    def write_output(self, it: int, x) -> None:
        """Per-`write_output_frequency` user hook."""
