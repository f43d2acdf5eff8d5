"""COPS 3.0 benchmark problems (counterpart of paropt_tpu/models/cops.py,
the reference's ``examples/COPS/``).

- `Electron`: problem 2, n point charges on the unit sphere minimizing the
  Coulomb potential, with the n sphere equalities as dense constraints;
- `ElectronCSR`: the same problem with the sphere equalities as general-CSR
  sparse constraints (three entries per row), as the reference poses it;
- `Polygon`: problem 1, the largest small polygon in polar coordinates.

Each takes ``dtype`` and ``device`` (None: the card) and turns TF32 off for
float32 matrix products.  The starts, constants and scalings are the JAX
models'.
"""

from __future__ import annotations

import numpy as np
import torch

from ..dtypes import resolve_device, resolve_dtype
from ..problem import CSRSparseProblem, Problem

__all__ = ["Electron", "ElectronCSR", "Polygon"]


def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _electron_objective(xyz, n, iu, eps):
    pts = xyz.reshape(3, n).T  # [n, 3]
    diff = pts[:, None, :] - pts[None, :, :]
    dsq = torch.sum(diff * diff, dim=-1)
    d = torch.clamp(dsq[iu[0], iu[1]], min=eps)
    return torch.sum(d ** -0.5)


def _electron_start(n):
    rng = np.random.default_rng(0)
    alpha = rng.uniform(0.0, 2 * np.pi, n)
    beta = rng.uniform(-np.pi, np.pi, n)
    return np.concatenate([np.cos(beta) * np.cos(alpha),
                           np.cos(beta) * np.sin(alpha), np.sin(beta)])


class _Electron:
    """The charges' objective, sphere constraints and start."""

    def _setup(self, n, epsilon, dtype, device):
        _no_tf32()
        self.npts = n
        self.eps = epsilon
        self._dtype = resolve_dtype(dtype)
        self._device = resolve_device(device)
        self._iu = torch.as_tensor(np.array(np.triu_indices(n, k=1)),
                                   device=self._device)

    def objective(self, x):
        return _electron_objective(x, self.npts, self._iu, self.eps)

    def _sphere(self, x):
        n = self.npts
        return 1.0 - (x[:n] ** 2 + x[n:2 * n] ** 2 + x[2 * n:] ** 2)

    def get_vars_and_bounds(self):
        kw = dict(dtype=self._dtype, device=self._device)
        n3 = 3 * self.npts
        return (torch.as_tensor(_electron_start(self.npts), **kw),
                torch.full((n3,), -10.0, **kw), torch.full((n3,), 10.0, **kw))


class Electron(_Electron, Problem):
    """Dense-constraint form: n sphere equality constraints."""

    def __init__(self, n: int = 10, epsilon: float = 1e-10, dtype=None,
                 device=None):
        Problem.__init__(self, nvars=3 * n, ncon=n, ninequality=0)
        self._setup(n, epsilon, dtype, device)

    def constraints(self, x):
        return self._sphere(x)


class ElectronCSR(_Electron, CSRSparseProblem):
    """General-CSR sparse-constraint form: row i holds the three
    coordinates of charge i; all rows are equalities."""

    def __init__(self, n: int = 10, epsilon: float = 1e-10, dtype=None,
                 device=None):
        rowp = np.arange(n + 1, dtype=np.int32) * 3
        cols = np.stack([np.arange(n), n + np.arange(n),
                         2 * n + np.arange(n)], axis=1).reshape(-1)
        CSRSparseProblem.__init__(self, nvars=3 * n, ncon=0, rowp=rowp,
                                  cols=cols.astype(np.int32),
                                  nwinequality=0, device=device)
        self._setup(n, epsilon, dtype, device)

    def sparse_constraints(self, x):
        return self._sphere(x)

    def eval_sparse_jacobian_data(self, x):
        """-2·(x_i, y_i, z_i) per row, from one read of x to the host."""
        xnp = self.syncs.array(x) if isinstance(x, torch.Tensor) \
            else np.asarray(x)
        n = self.npts
        return (-2.0 * np.asarray(xnp, np.float64).reshape(3, n).T).reshape(-1)


class Polygon(Problem):
    """Largest small polygon: vertices (r_i, θ_i), i = 0..nv-1; maximize
    the area 1/2 Σ r_i r_{i+1} sin(θ_{i+1} − θ_i) subject to unit diameter
    (pairwise squared distances <= 1) and ordered angles."""

    def __init__(self, nv: int = 6, dtype=None, device=None):
        _no_tf32()
        self.nv = nv
        npairs = nv * (nv - 1) // 2
        super().__init__(nvars=2 * nv, ncon=npairs + (nv - 1))
        self._dtype = resolve_dtype(dtype)
        self._device = resolve_device(device)
        self._iu = torch.as_tensor(np.array(np.triu_indices(nv, k=1)),
                                   device=self._device)

    def _split(self, x):
        return x[:self.nv], x[self.nv:]

    def objective(self, x):
        r, th = self._split(x)
        return -0.5 * torch.sum(r[:-1] * r[1:] * torch.sin(th[1:] - th[:-1]))

    def constraints(self, x):
        r, th = self._split(x)
        ri, rj = r[self._iu[0]], r[self._iu[1]]
        ti, tj = th[self._iu[0]], th[self._iu[1]]
        dsq = ri ** 2 + rj ** 2 - 2.0 * ri * rj * torch.cos(tj - ti)
        return torch.cat([1.0 - dsq, th[1:] - th[:-1]])

    def get_vars_and_bounds(self):
        nv = self.nv
        kw = dict(dtype=self._dtype, device=self._device)
        x0 = np.concatenate([np.full(nv, 0.5),
                             np.linspace(0.1, np.pi - 0.1, nv)])
        lb = np.concatenate([np.full(nv, 1e-3), np.zeros(nv)])
        ub = np.concatenate([np.ones(nv), np.full(nv, np.pi)])
        return tuple(torch.as_tensor(a, **kw) for a in (x0, lb, ub))

    def area(self, x):
        return -float(self.objective(x))
