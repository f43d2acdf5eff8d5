"""Truss sizing and discrete-material (DMO) truss optimization (counterpart
of paropt_tpu/models/truss.py, the reference's ``examples/truss/`` and
``examples/dmo_truss/``).

A 2-D ground-structure truss FEM in torch: the compliance differentiates
through the dense linear solve, so every gradient is the exact adjoint by
autodiff.

- `TrussSizing`: design = bar areas, min compliance s.t. mass <= m0.
- `DMOTruss`: design = per-bar material weights w[e, m] with SIMP-style
  penalized stiffness; one dense mass constraint and one sparse weighting
  constraint per bar, 1 - Σ_m w[e, m] >= 0, whose pattern is 'blocked'
  (a reshape per product; no quasi-definite kernel serves it).

Each takes ``dtype`` and ``device`` (None: the card) and turns TF32 off.
"""

from __future__ import annotations

import numpy as np
import torch

from ..dtypes import resolve_device, resolve_dtype
from ..problem import Problem, SparseJacobian

__all__ = ["TrussSizing", "DMOTruss", "make_ground_structure"]


def make_ground_structure(nx: int = 4, ny: int = 3):
    """Grid ground structure: nodes on an nx x ny grid, bars to the right,
    up and both diagonals; the left edge fixed, a unit downward load at the
    right-middle node.  Returns numpy (xy [nn, 2], bars [nb, 2], fixed_dof,
    f)."""
    nodes = [(i, j) for j in range(ny) for i in range(nx)]
    idx = {n: k for k, n in enumerate(nodes)}
    bars = []
    for (i, j) in nodes:
        for di, dj in ((1, 0), (0, 1), (1, 1), (1, -1)):
            if (i + di, j + dj) in idx:
                bars.append((idx[(i, j)], idx[(i + di, j + dj)]))
    xy = np.asarray(nodes, dtype=float)
    bars = np.asarray(bars, dtype=np.int32)
    fixed = []
    for (i, j) in nodes:
        if i == 0:
            k = idx[(i, j)]
            fixed.extend([2 * k, 2 * k + 1])
    f = np.zeros(2 * len(nodes))
    f[2 * idx[(nx - 1, ny // 2)] + 1] = -1.0
    return xy, bars, np.asarray(fixed, np.int32), f


class _TrussFEM:
    """B [nbars, ndof_free], the scaled direction incidence, so that
    K(s) = Bᵀ diag(s / L) B."""

    def __init__(self, nx, ny, dtype, device):
        xy, bars, fixed, f = make_ground_structure(nx, ny)
        ndof = 2 * xy.shape[0]
        free = np.setdiff1d(np.arange(ndof), fixed)
        self.nbars = bars.shape[0]
        dvec = xy[bars[:, 1]] - xy[bars[:, 0]]
        L = np.linalg.norm(dvec, axis=1)
        d = dvec / L[:, None]
        B = np.zeros((self.nbars, ndof))
        for e, (a, b) in enumerate(bars):
            B[e, 2 * a:2 * a + 2] = -d[e]
            B[e, 2 * b:2 * b + 2] = d[e]
        kw = dict(dtype=dtype, device=device)
        self.L_np = L
        self.B = torch.as_tensor(B[:, free], **kw)
        self.L = torch.as_tensor(L, **kw)
        self.f = torch.as_tensor(f[free], **kw)
        self.eye = torch.eye(len(free), **kw)

    def compliance(self, stiffness):
        """fᵀu with (Bᵀ diag(s/L) B + 1e-6 I) u = f."""
        K = (self.B.T * (stiffness / self.L)) @ self.B + 1e-6 * self.eye
        u = torch.linalg.solve(K, self.f)
        return torch.dot(self.f, u)


def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class TrussSizing(Problem):
    """min compliance(areas) s.t. mass(areas) <= m0, a in [1e-3, 1]."""

    def __init__(self, nx: int = 4, ny: int = 3, mass_fraction: float = 0.3,
                 E: float = 10.0, rho: float = 1.0, dtype=None, device=None):
        _no_tf32()
        self._dtype = resolve_dtype(dtype)
        self._device = resolve_device(device)
        self.fem = _TrussFEM(nx, ny, self._dtype, self._device)
        super().__init__(nvars=self.fem.nbars, ncon=1)
        self.E = E
        self.rho = rho
        self.m0 = mass_fraction * float(np.sum(rho * 1.0 * self.fem.L_np))

    def objective(self, a):
        return self.fem.compliance(self.E * a)

    def constraints(self, a):
        mass = torch.sum(self.rho * a * self.fem.L)
        return (1.0 - mass / self.m0).reshape(1)

    def get_vars_and_bounds(self):
        kw = dict(dtype=self._dtype, device=self._device)
        nb = self.nvars
        return (torch.full((nb,), 0.3, **kw), torch.full((nb,), 1e-3, **kw),
                torch.ones(nb, **kw))


class DMOTruss(Problem):
    """Discrete material optimization: per-bar material weights w[e, m],
    SIMP-penalized stiffness, a mass constraint and per-bar weighting
    constraints."""

    def __init__(self, nx: int = 4, ny: int = 3, materials=None,
                 penalty: float = 3.0, mass_fraction: float = 0.4,
                 dtype=None, device=None):
        _no_tf32()
        self._dtype = resolve_dtype(dtype)
        self._device = resolve_device(device)
        kw = dict(dtype=self._dtype, device=self._device)
        self.fem = _TrussFEM(nx, ny, self._dtype, self._device)
        if materials is None:
            # (E, rho): stiff and heavy, medium, light and soft
            materials = [(10.0, 1.0), (6.0, 0.55), (3.0, 0.25)]
        self.E = torch.as_tensor([m[0] for m in materials], **kw)
        self.rho = torch.as_tensor([m[1] for m in materials], **kw)
        self.nmat = len(materials)
        nbars = self.fem.nbars
        nvars = nbars * self.nmat
        super().__init__(nvars=nvars, ncon=1, nwcon=nbars, nwblock=1)
        self.p = penalty
        self.a0 = 1.0
        self.m0 = mass_fraction * float(
            max(m[1] for m in materials) * self.a0 * np.sum(self.fem.L_np))
        # variables laid out [nbars, nmat]: the 'blocked' pattern
        cols = np.arange(nvars, dtype=np.int64).reshape(nbars, self.nmat)
        self._jac = SparseJacobian(nvars, cols,
                                   -torch.ones((nbars, self.nmat), **kw),
                                   nwblock=1)

    def _weights(self, x):
        return x.reshape(self.fem.nbars, self.nmat)

    def objective(self, x):
        stiff = self.a0 * (self._weights(x) ** self.p) @ self.E
        return self.fem.compliance(stiff + 1e-8)

    def constraints(self, x):
        mass = self.a0 * torch.sum((self._weights(x) @ self.rho)
                                   * self.fem.L)
        return (1.0 - mass / self.m0).reshape(1)

    def sparse_constraints(self, x):
        return 1.0 - torch.sum(self._weights(x), dim=1)

    def sparse_jacobian(self, x):
        return self._jac

    def get_vars_and_bounds(self):
        kw = dict(dtype=self._dtype, device=self._device)
        n = self.nvars
        return (torch.full((n,), 1.0 / (self.nmat + 1), **kw),
                torch.full((n,), 1e-4, **kw), torch.ones(n, **kw))
