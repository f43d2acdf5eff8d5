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
(or the complex step).  ``CSRSparseProblem`` states a general-CSR sparse
Jacobian pattern once and fills its values per point; its quasi-definite
factor is the native host sparse Cholesky (`ops.sparse_native`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .dtypes import resolve_device
from .parallel.sharding import is_sharded, shard_like

__all__ = ["Problem", "SparseJacobian", "check_gradients",
           "CSRSparseProblem"]


class SparseJacobian:
    """Structured sparse Jacobian Aw of the separable constraints.

    Each of the ``nwcon`` rows has exactly ``k`` nonzeros, ``cols[i, j]``
    indexing into x with value ``vals[i, j]``.  ``layout`` classifies the
    pattern (`ops.kkt.detect_aw_layout`): for the partition patterns
    ('blocked', 'blocked_t') every product is a reshape.  A caller that
    knows the layout passes it with ``cols`` as an int64 tensor on the
    values' device, which is then used as it is."""

    def __init__(self, nvars: int, cols, vals: torch.Tensor,
                 nwblock: int = 1, layout: Optional[str] = None):
        from .ops.kkt import detect_aw_layout
        if layout is None:
            cols_np = np.asarray(cols)
            layout = detect_aw_layout(cols_np, nvars)
            cols = torch.as_tensor(cols_np, dtype=torch.long,
                                   device=vals.device)
        if cols.dim() != 2:
            raise ValueError("cols must be [nwcon, k]")
        self.nvars = int(nvars)
        self.nwcon, self.k = (int(s) for s in cols.shape)
        self.nwblock = int(nwblock)
        if self.nwcon % max(self.nwblock, 1):
            raise ValueError("nwcon must be a multiple of nwblock")
        self.vals = vals
        self.cols = cols
        self.layout = layout

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
        """-> (g[n], A[ncon, n]).  On a sharded x both come back sharded
        like x (a derivative of a mean, say, is a replicated broadcast in
        DTensor)."""
        g = torch.func.grad(self.objective)(x)
        if self.ncon > 0:
            A = torch.func.jacrev(self.constraints)(x)
        else:
            A = x.new_zeros((0, self.nvars))
        if is_sharded(x):
            g, A = shard_like(g, x), shard_like(A, x)
        return g, A

    def eval_hvec_product(self, x, z, zw, px) -> torch.Tensor:
        """H(x, z, zw) @ px for L = f - z.c - zw.cw: forward mode over
        reverse mode.  Forward mode has no DTensor rules, so on sharded
        state the same product comes from reverse over reverse, the
        gradient of <∇L(x), px> (H is symmetric)."""
        def lag_grad(xv):
            g = torch.func.grad(self.objective)(xv)
            if self.ncon > 0:
                g = g - torch.func.vjp(self.constraints, xv)[1](z)[0]
            if self.nwcon > 0:
                g = g - torch.func.vjp(self.sparse_constraints, xv)[1](zw)[0]
            return g
        if is_sharded(x):
            return torch.func.grad(
                lambda xv: torch.sum(lag_grad(xv) * px))(x)
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

        # block inner product: e_i^T (Aw C Aw^T) e_j against the products.
        # Only the block path has one: a general-CSR problem's rows may
        # overlap, and its Aw D Aw^T goes through the sparse factor instead
        if not getattr(problem, "use_csr_path", False):
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
                approx = torch.zeros(problem.nwcon, dtype=x.dtype,
                                     device=dev)
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
    of paropt_tpu/problem.py:387, ``ParOptSparseProblem``'s role): the
    pattern (``rowp``, ``cols``) is given once, and
    ``eval_sparse_jacobian_data(x)`` returns the values in pattern order, a
    device tensor or a host array.  Aw·D·Awᵀ need not be block diagonal:
    the quasi-definite factor is the native host sparse Cholesky
    (`create_quasi_def_mat`).

    The padded [nwcon, kmax] columns and their mask live on ``device``
    (None: the card), and the products use them; the latest values are
    kept on the host in float64 (``_data``), where the factor reads them.
    ``syncs`` counts the problem's reads to the host (a fill's values) and
    the bytes moved each way."""

    def __init__(self, nvars: int, ncon: int, rowp, cols,
                 ninequality: Optional[int] = None,
                 nwinequality: Optional[int] = None, device=None):
        from .ip import HostSyncs
        from .ops.kkt import detect_aw_layout
        rowp = np.asarray(rowp, dtype=np.int32)
        cols = np.asarray(cols, dtype=np.int32)
        nwcon = rowp.shape[0] - 1
        super().__init__(nvars=nvars, ncon=ncon, nwcon=nwcon, nwblock=1,
                         ninequality=ninequality, nwinequality=nwinequality)
        self.csr_rowp, self.csr_cols = rowp, cols
        self.use_csr_path = True
        self.syncs = HostSyncs()
        self._device = resolve_device(device)
        counts = np.diff(rowp)
        self._kmax = int(counts.max()) if nwcon else 0
        # entry p of the pattern sits at [row, slot] of the padded form
        mask = np.arange(self._kmax)[None, :] < counts[:, None]
        pad_cols = np.zeros((nwcon, self._kmax), dtype=np.int64)
        pad_cols[mask] = cols
        self._pad_layout = detect_aw_layout(pad_cols, nvars)
        self._pad_mask = torch.as_tensor(mask, device=self._device)
        self._pad_cols = torch.as_tensor(pad_cols, device=self._device)
        self._data = np.zeros(rowp[-1])

    # -- user surface --------------------------------------------------------
    def eval_sparse_jacobian_data(self, x):
        """The CSR values of Aw(x), aligned with the pattern."""
        raise NotImplementedError(
            "override eval_sparse_jacobian_data(x) for CSRSparseProblem")

    def colored_jacobian_fill(self, fn=None):
        """An ``x -> CSR values`` filler by colored forward-mode
        differentiation of ``fn`` (default ``self.sparse_constraints``).

        The columns are colored greedily, exactly as the JAX package does,
        so that no row touches two columns of one color; one
        ``torch.func.jvp`` per color, all under ``torch.func.vmap`` on the
        device, then yields every entry (a banded collocation Jacobian
        needs ~9-13 colors whatever its length)."""
        fn = fn if fn is not None else self.sparse_constraints
        rowp, cols = self.csr_rowp, self.csr_cols
        col_rows = [[] for _ in range(self.nvars)]
        for r in range(self.nwcon):
            for k in range(rowp[r], rowp[r + 1]):
                col_rows[cols[k]].append(r)
        row_used = [set() for _ in range(self.nwcon)]
        color = np.full(self.nvars, -1, dtype=np.int64)
        for c in range(self.nvars):
            if not col_rows[c]:
                color[c] = 0
                continue
            forbidden = set()
            for r in col_rows[c]:
                forbidden |= row_used[r]
            col = 0
            while col in forbidden:
                col += 1
            color[c] = col
            for r in col_rows[c]:
                row_used[r].add(col)
        ncolors = int(color.max()) + 1
        seeds = np.zeros((ncolors, self.nvars))
        seeds[color, np.arange(self.nvars)] = 1.0
        dev = self._device
        seeds_t = torch.as_tensor(seeds, device=dev)
        rows_idx = torch.as_tensor(np.repeat(np.arange(self.nwcon),
                                             np.diff(rowp)), device=dev)
        entry_colors = torch.as_tensor(color[cols], device=dev)

        def fill(x):
            s = seeds_t.to(x.dtype)
            jcols = torch.func.vmap(
                lambda si: torch.func.jvp(fn, (x,), (si,))[1])(s)
            return jcols[entry_colors, rows_idx]   # [nnz]

        return fill

    def set_sparse_jacobian_data(self, data) -> None:
        """Keep the values on the host in float64 (one read of a device
        tensor)."""
        if isinstance(data, torch.Tensor):
            data = self.syncs.array(data)
        self._data = np.asarray(data, dtype=np.float64)

    # -- generic implementations --------------------------------------------
    def _padded_vals(self, data) -> torch.Tensor:
        """[nwcon, kmax] float64 values on the device, zero-padded."""
        if isinstance(data, torch.Tensor):
            flat = data.to(device=self._device, dtype=torch.float64)
        else:
            flat = self.syncs.upload(np.asarray(data, np.float64),
                                     self._device)
        vals = torch.zeros((self.nwcon, self._kmax), dtype=torch.float64,
                           device=self._device)
        return vals.masked_scatter(self._pad_mask, flat)

    def sparse_jacobian(self, x) -> SparseJacobian:
        data = self.eval_sparse_jacobian_data(x)
        self.set_sparse_jacobian_data(data)
        return SparseJacobian(self.nvars, self._pad_cols,
                              self._padded_vals(data), nwblock=1,
                              layout=self._pad_layout)

    def create_quasi_def_mat(self):
        """The native general-CSR quasi-definite factor
        (``createQuasiDefMat``)."""
        from .ops.sparse_native import CSRQuasiDefMat
        return CSRQuasiDefMat(self.nvars, self.csr_rowp, self.csr_cols)
