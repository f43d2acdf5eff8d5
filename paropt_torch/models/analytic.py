"""Analytic benchmark problems mirroring the reference examples (counterpart
of paropt_tpu/models/analytic.py, where each problem's source example is
named).

Every problem takes ``dtype`` and ``device``; its gradients and Jacobians
come from ``torch.func``.  The random problems draw from
``numpy.random.default_rng(seed)`` exactly as the JAX models do, so both
packages solve the same problem.

- `Rosenbrock`, `SparseRosenbrock` (the constraint as one sparse row),
  `ScalableRosenbrock` (chained, with 'blocked' sparse group constraints);
- `RandomConvexQP`, `RandomQuadratic` (prescribed spectrum);
- `Sellar` (two constraints), `Toy` (two balls), `Maratos` (one equality),
  `SimpleQuadratic` (bounds only).
"""

from __future__ import annotations

import numpy as np
import torch

from ..dtypes import resolve_device, resolve_dtype
from ..problem import Problem, SparseJacobian

__all__ = ["Rosenbrock", "SparseRosenbrock", "ScalableRosenbrock",
           "RandomConvexQP", "Sellar", "SimpleQuadratic", "Toy",
           "Maratos", "RandomQuadratic"]


class _Analytic(Problem):
    """Holds the dtype and device of the problem's tensors."""

    def __init__(self, *args, dtype=None, device=None, **kwargs):
        super().__init__(*args, **kwargs)
        self._dtype = resolve_dtype(dtype)
        self._device = resolve_device(device)

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, dtype=np.float64),
                               dtype=self._dtype, device=self._device)

    def _full(self, value) -> torch.Tensor:
        return torch.full((self.nvars,), value, dtype=self._dtype,
                          device=self._device)


def _rosenbrock2(x):
    return 100.0 * (x[1] - x[0] ** 2) ** 2 + (1.0 - x[0]) ** 2


class Rosenbrock(_Analytic):
    """2-var Rosenbrock, one dense constraint c = x0 + x1 + 5 >= 0."""

    def __init__(self, x0=None, dtype=None, device=None):
        super().__init__(nvars=2, ncon=1, dtype=dtype, device=device)
        self._x0 = (-1.5, -1.0) if x0 is None else x0

    def objective(self, x):
        return _rosenbrock2(x)

    def constraints(self, x):
        return (x[0] + x[1] + 5.0).reshape(1)

    def get_vars_and_bounds(self):
        return self._tensor(self._x0), self._full(-2.0), self._full(2.0)


class SparseRosenbrock(_Analytic):
    """Rosenbrock with the linear constraint as a sparse weighting
    constraint (nwcon=1, nwblock=1)."""

    def __init__(self, x0=None, dtype=None, device=None):
        super().__init__(nvars=2, ncon=0, nwcon=1, nwblock=1, dtype=dtype,
                         device=device)
        self._x0 = (-1.5, -1.0) if x0 is None else x0
        self._jac = SparseJacobian(nvars=2, cols=np.array([[0, 1]]),
                                   vals=self._tensor([[1.0, 1.0]]),
                                   nwblock=1)

    def objective(self, x):
        return _rosenbrock2(x)

    def sparse_constraints(self, x):
        return (x[0] + x[1] + 5.0).reshape(1)

    def sparse_jacobian(self, x):
        return self._jac

    def get_vars_and_bounds(self):
        return self._tensor(self._x0), self._full(-2.0), self._full(2.0)


class ScalableRosenbrock(_Analytic):
    """n-var chained Rosenbrock with one dense constraint and optional
    sparse group constraints cw = group/2 - sum(x_group) >= 0."""

    def __init__(self, n=64, group=4, use_sparse=True, dtype=None,
                 device=None):
        if n % group:
            raise ValueError("n must be a multiple of group")
        nwcon = n // group if use_sparse else 0
        super().__init__(nvars=n, ncon=1, nwcon=nwcon, nwblock=1,
                         dtype=dtype, device=device)
        self.group = group
        if use_sparse:
            self._jac = SparseJacobian(
                nvars=n, cols=np.arange(n).reshape(nwcon, group),
                vals=self._tensor(-np.ones((nwcon, group))), nwblock=1)

    def objective(self, x):
        return torch.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2
                         + (1.0 - x[:-1]) ** 2)

    def constraints(self, x):
        return (0.25 * self.nvars - torch.sum(x ** 2)).reshape(1)

    def sparse_constraints(self, x):
        return (0.5 * self.group
                - torch.sum(x.reshape(self.nwcon, self.group), dim=1))

    def sparse_jacobian(self, x):
        return self._jac

    def get_vars_and_bounds(self):
        n = self.nvars
        x = -0.5 + 0.1 * np.sin(np.arange(n, dtype=np.float64))
        return self._tensor(x), self._full(-2.0), self._full(2.0)


class RandomConvexQP(_Analytic):
    """Convex QP:  min 1/2 x'Qx - b'x  s.t.  Ax - 1 >= 0, 0 <= x <= 10
    with random SPD Q."""

    def __init__(self, n=32, ncon=4, seed=0, dtype=None, device=None):
        super().__init__(nvars=n, ncon=ncon, dtype=dtype, device=device)
        rng = np.random.default_rng(seed)
        M = rng.standard_normal((n, n)) / np.sqrt(n)
        self.Q = self._tensor(M @ M.T + 0.5 * np.eye(n))
        self.b = self._tensor(rng.standard_normal(n))
        self.Amat = self._tensor(np.abs(rng.standard_normal((ncon, n))) / n)

    def objective(self, x):
        return 0.5 * torch.dot(x, self.Q @ x) - torch.dot(self.b, x)

    def constraints(self, x):
        return self.Amat @ x - 1.0

    def get_vars_and_bounds(self):
        return self._full(2.0), self._full(0.0), self._full(10.0)


class Sellar(_Analytic):
    """The reduced Sellar form: min x0² + x1 + x2 + exp(-x3) with two
    constraints."""

    def __init__(self, dtype=None, device=None):
        super().__init__(nvars=4, ncon=2, dtype=dtype, device=device)

    def objective(self, x):
        return x[0] ** 2 + x[1] + x[2] + torch.exp(-x[3])

    def constraints(self, x):
        y1 = x[1] + x[0] ** 2 + x[2] - 0.2 * x[3]
        y2 = torch.sqrt(torch.abs(y1) + 1e-12) + x[1] + x[2]
        return torch.stack([y1 / 3.16 - 1.0, 1.0 - y2 / 24.0])

    def get_vars_and_bounds(self):
        return (self._tensor([1.0, 5.0, 2.0, 1.0]),
                self._tensor([-10.0, 0.0, 0.0, -10.0]), self._full(10.0))


class SimpleQuadratic(_Analytic):
    """min ||x - x_target||² in [-1, 1]^n; the optimum is
    clip(x_target, -1, 1)."""

    def __init__(self, n=16, target_scale=2.0, dtype=None, device=None):
        super().__init__(nvars=n, ncon=0, dtype=dtype, device=device)
        self.target = self._tensor(np.linspace(-target_scale, target_scale,
                                               n))

    def objective(self, x):
        return torch.sum((x - self.target) ** 2)

    def get_vars_and_bounds(self):
        return self._full(0.0), self._full(-1.0), self._full(1.0)

    def solution(self):
        return torch.clamp(self.target, -1.0, 1.0)


class Maratos(_Analytic):
    """Nocedal & Wright example 15.4: min 2 (x0 - 0.5)² + 2 x1² subject to
    the EQUALITY x0² + x1² - 2 = 0 (ninequality=0), x in [-10, 10]² from
    (1, 1); x* = (sqrt(2), 0)."""

    def __init__(self, x0=(1.0, 1.0), dtype=None, device=None):
        super().__init__(nvars=2, ncon=1, ninequality=0, dtype=dtype,
                         device=device)
        self._x0 = x0

    def objective(self, x):
        return 2.0 * (x[0] - 0.5) ** 2 + 2.0 * x[1] ** 2

    def constraints(self, x):
        return (x[0] ** 2 + x[1] ** 2 - 2.0).reshape(1)

    def get_vars_and_bounds(self):
        return self._tensor(self._x0), self._full(-10.0), self._full(10.0)

    def solution(self):
        return self._tensor([np.sqrt(2.0), 0.0])


class RandomQuadratic(_Analytic):
    """min 1/2 x'Ax + b'x with A = Q diag(eigs) Q' (Q random orthogonal)
    subject to a'x + b0 >= 0, x in [-5, 5]^n."""

    def __init__(self, eigs, seed=0, dtype=None, device=None):
        eigs = np.asarray(eigs, dtype=float)
        n = eigs.size
        super().__init__(nvars=n, ncon=1, dtype=dtype, device=device)
        rng = np.random.default_rng(seed)
        Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
        self.A = self._tensor(Q @ np.diag(eigs) @ Q.T)
        self.b = self._tensor(rng.uniform(size=n))
        self.acon = self._tensor(rng.uniform(size=n))
        self.bcon = float(rng.uniform())
        self._x0 = -2.0 + rng.uniform(size=n)

    def objective(self, x):
        return 0.5 * torch.dot(x, self.A @ x) + torch.dot(self.b, x)

    def constraints(self, x):
        return (torch.dot(self.acon, x) + self.bcon).reshape(1)

    def get_vars_and_bounds(self):
        return self._tensor(self._x0), self._full(-5.0), self._full(5.0)


class Toy(_Analytic):
    """Min-norm point inside two intersecting balls: min Σx² subject to
    9 - |x - c_i|² >= 0 for two centers, x in [0, 5]³."""

    def __init__(self, dtype=None, device=None):
        super().__init__(nvars=3, ncon=2, dtype=dtype, device=device)
        self.centers = self._tensor([[5.0, 2.0, 1.0], [3.0, 4.0, 3.0]])

    def objective(self, x):
        return torch.sum(x ** 2)

    def constraints(self, x):
        return 9.0 - torch.sum((x[None, :] - self.centers) ** 2, dim=1)

    def get_vars_and_bounds(self):
        return (self._tensor([4.0, 3.0, 2.0]), self._full(0.0),
                self._full(5.0))
