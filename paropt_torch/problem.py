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
``check_gradients`` verifies a problem's derivatives by finite differences
(or the complex step).  The general-CSR problem (``CSRSparseProblem``) is
not ported yet.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

__all__ = ["Problem", "SparseJacobian", "check_gradients",
           "CSRSparseProblem"]


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

    # -- verification --------------------------------------------------------
    def check_gradients(self, dh: Optional[float] = None, x=None,
                        check_hvec_product: bool = False,
                        verbose: bool = True, mode: str = "central"):
        return check_gradients(self, dh, x=x,
                               check_hvec_product=check_hvec_product,
                               verbose=verbose, mode=mode)


def check_gradients(problem: Problem, dh: Optional[float] = None, x=None,
                    check_hvec_product: bool = False, verbose: bool = True,
                    mode: str = "central"):
    """Finite-difference / complex-step derivative verification
    (``ParOptProblem::checkGradients``, `ParOptProblem.cpp:225-622`).

    Probes the objective and constraint gradients along px = sign(g); with
    ``check_hvec_product`` the Hessian-vector product (``torch.func`` by
    default) against central differences of the Lagrangian gradient and its
    repeatability; for sparse constraints the Jacobian products, their
    adjoint consistency <zw, Aw px> == <Aw^T zw, px> and the block inner
    product Aw C Aw^T.  mode='complex' takes the complex-step derivative
    Im(f(x + i dh px))/dh of the objective and dense constraints instead.
    ``dh`` defaults to 1e-6 in float64 and 5e-3 in narrower precision.
    Returns a dict of relative errors."""
    if x is None:
        x, _, _ = problem.get_vars_and_bounds()
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(x)
    if dh is None:
        # central differences lose ~eps^(2/3): f32 needs a larger step
        dh = 1e-6 if x.dtype == torch.float64 else 5e-3
    dev = x.device
    out = {}

    f0, c0 = problem.eval_obj_con(x)
    g, A = problem.eval_obj_con_gradient(x)
    one = torch.ones_like(x)
    px = torch.where(g >= 0, one, -one)

    def rel(num, den):
        return float(num) / max(abs(float(den)), 1e-30)

    if mode == "complex":
        c128 = torch.complex128
        fc, cc = problem.eval_obj_con(x.to(c128) + 1j * dh * px.to(c128))
        an_obj = torch.dot(g, px)
        out["obj_gradient"] = rel(abs(torch.imag(fc) / dh - an_obj), an_obj)
        if problem.ncon > 0:
            an_con = A @ px
            out["con_gradient"] = float(torch.max(
                torch.abs(torch.imag(cc) / dh - an_con)
                / torch.clamp(torch.abs(an_con), min=1e-30)))
        if verbose:
            for k, v in out.items():
                print(f"  check_gradients[complex]: {k:22s} "
                      f"rel err {v:10.3e}")
        return out

    fp, cp = problem.eval_obj_con(x + dh * px)
    fm, cm = problem.eval_obj_con(x - dh * px)
    an_obj = torch.dot(g, px)
    out["obj_gradient"] = rel(abs((fp - fm) / (2 * dh) - an_obj), an_obj)

    if problem.ncon > 0:
        an_con = A @ px
        out["con_gradient"] = float(torch.max(
            torch.abs((cp - cm) / (2 * dh) - an_con)
            / torch.clamp(torch.abs(an_con), min=1e-30)))

    if check_hvec_product:
        z = torch.ones(problem.ncon, dtype=x.dtype, device=dev)
        zw = torch.ones(problem.nwcon, dtype=x.dtype, device=dev)
        hv = problem.eval_hvec_product(x, z, zw, px)

        def lag_grad(xv):
            gv, Av = problem.eval_obj_con_gradient(xv)
            if problem.ncon:
                gv = gv - Av.T @ z
            if problem.nwcon > 0:
                gv = gv - problem.sparse_jacobian_tvec(xv, zw)
            return gv

        fd_hv = (lag_grad(x + dh * px) - lag_grad(x - dh * px)) / (2 * dh)
        # reproducibility of repeated products (ParOptProblem.cpp:319-333)
        hv2 = problem.eval_hvec_product(x, z, zw, px)
        out["hvec_repeat"] = float(torch.max(torch.abs(hv - hv2)))
        nrm = float(torch.linalg.norm(hv)) or 1e-30
        out["hvec_product"] = float(torch.linalg.norm(fd_hv - hv)) / nrm

    if problem.nwcon > 0:
        cwp = problem.eval_sparse_con(x + dh * px)
        cwm = problem.eval_sparse_con(x - dh * px)
        an_cw = problem.sparse_jacobian_vec(x, px)
        out["sparse_jacobian"] = (
            float(torch.max(torch.abs((cwp - cwm) / (2 * dh) - an_cw)))
            / max(float(torch.max(torch.abs(an_cw))), 1e-30))

        # adjoint consistency <zw, Aw px> == <Aw^T zw, px>
        key = np.random.default_rng(0)
        zw = torch.as_tensor(key.uniform(size=problem.nwcon),
                             dtype=x.dtype, device=dev)
        lhs = torch.dot(zw, problem.sparse_jacobian_vec(x, px))
        rhs = torch.dot(problem.sparse_jacobian_tvec(x, zw), px)
        out["sparse_adjoint"] = rel(abs(lhs - rhs), lhs)

        # block inner product: e_i^T (Aw C Aw^T) e_j against the products
        cvec = torch.as_tensor(key.uniform(size=problem.nvars) + 0.5,
                               dtype=x.dtype, device=dev)
        blocks = problem.sparse_inner_product(x, cvec)
        nb = problem.nwblock
        errs = []
        for i in range(min(problem.nwcon, 4 * nb)):
            ei = torch.zeros(problem.nwcon, dtype=x.dtype, device=dev)
            ei[i] = 1.0
            row = problem.sparse_jacobian_vec(
                x, cvec * problem.sparse_jacobian_tvec(x, ei))
            b = i // nb
            approx = torch.zeros(problem.nwcon, dtype=x.dtype, device=dev)
            approx[b * nb:(b + 1) * nb] = blocks[b][:, i % nb]
            errs.append(float(torch.max(torch.abs(row - approx))))
        out["sparse_inner_product"] = max(errs) / max(
            float(torch.max(torch.abs(blocks))), 1e-30)

    if verbose:
        for k, v in out.items():
            print(f"  check_gradients: {k:22s} rel err {v:10.3e}")
    return out


class CSRSparseProblem(Problem):
    """A problem with a general-CSR sparse constraint Jacobian (counterpart
    of paropt_tpu/problem.py:387, whose quasi-definite factor is the native
    sparse Cholesky).  Not ported yet: constructing one raises."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "CSRSparseProblem (the general-CSR path and its native sparse "
            "factor) is not ported yet (ROADMAP queue 1 item 11)")
