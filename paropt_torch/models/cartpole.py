"""Cart-pole swing-up trajectory optimization (counterpart of
paropt_tpu/models/cartpole.py, the reference's ``examples/cart_pole/``):
the minimum-energy force history u(t) that swings the pole from hanging at
rest to upright at rest, by single shooting with 4 terminal equalities.

Each implicit-midpoint time step runs a fixed number of Newton iterations
on its 4-dimensional residual, as the JAX model does inside ``lax.scan``;
here the steps are a Python loop, and the gradients come by autograd
through it (``torch.func``, as for every model of the port).  The Newton
Jacobian is written out, where JAX takes ``jacfwd`` of the residual: the
converged step is the same to roundoff, at a tenth of the eager cost.
"""

from __future__ import annotations

import numpy as np
import torch

from ..dtypes import resolve_device, resolve_dtype
from ..problem import Problem

__all__ = ["CartPole"]


class CartPole(Problem):
    """Swing-up: nvars = nsteps control forces, ncon = 4 terminal
    equalities (x = 1, θ = π, ẋ = 0, θ̇ = 0), bounds |u| <= 20.  Takes
    ``dtype`` and ``device`` (None: the card)."""

    def __init__(self, nsteps: int = 63, tfinal: float = 2.0,
                 m1: float = 1.0, m2: float = 0.3, L: float = 0.5,
                 newton_iters: int = 8, dtype=None, device=None):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        super().__init__(nvars=nsteps, ncon=4, ninequality=0)
        self._dtype = resolve_dtype(dtype)
        self._device = resolve_device(device)
        kw = dict(dtype=self._dtype, device=self._device)
        self.m1, self.m2, self.L, self.grav = m1, m2, L, 9.81
        t = np.linspace(0.0, tfinal, nsteps + 1)
        self.t = torch.as_tensor(t, **kw)
        self.h = torch.as_tensor(t[1:] - t[:-1], **kw)
        self.newton_iters = newton_iters
        # the reference scales the small objective up and the constraints
        # to O(1)
        self.fobj_scale = 0.01
        self.con_scale = 10.0
        self.qtarget = torch.as_tensor([1.0, np.pi, 0.0, 0.0], **kw)

    # -- dynamics ------------------------------------------------------------
    def _qdot(self, q, u):
        """Explicit state derivative f(q, u) and its Jacobian df/dq."""
        theta, xd, td = q[1], q[2], q[3]
        m1, m2, L, g = self.m1, self.m2, self.L, self.grav
        st, ct = torch.sin(theta), torch.cos(theta)
        denom = m1 + m2 * st * st
        n1 = L * m2 * st * td ** 2 + u + m2 * g * ct * st
        n2 = L * m2 * ct * st * td ** 2 + u * ct + (m1 + m2) * g * st
        xdd = n1 / denom
        tdd = -n2 / (L * denom)
        # derivatives in θ and θ̇ (ẍ and θ̈ do not depend on x or ẋ)
        c2 = ct * ct - st * st
        ddenom = 2.0 * m2 * st * ct
        dn1 = L * m2 * ct * td ** 2 + m2 * g * c2
        dn2 = L * m2 * c2 * td ** 2 - u * st + (m1 + m2) * g * ct
        zero, one = torch.zeros_like(td), torch.ones_like(td)
        dfdq = torch.stack([
            torch.stack([zero, zero, one, zero]),
            torch.stack([zero, zero, zero, one]),
            torch.stack([zero, (dn1 - xdd * ddenom) / denom, zero,
                         2.0 * L * m2 * st * td / denom]),
            torch.stack([zero, -(dn2 + L * tdd * ddenom) / (L * denom),
                         zero, -2.0 * m2 * ct * st * td / denom])])
        return torch.stack([xd, td, xdd, tdd]), dfdq

    def _step(self, q_prev, h, u):
        """One implicit-midpoint step: r(q) = (q - q_prev)/h -
        f((q + q_prev)/2, u) = 0 by a fixed number of Newton iterations,
        with dr/dq = I/h - df/dq / 2."""
        eye = torch.eye(4, dtype=q_prev.dtype, device=q_prev.device)
        qn = q_prev
        for _ in range(self.newton_iters):
            f, dfdq = self._qdot(0.5 * (qn + q_prev), u)
            r = (qn - q_prev) / h - f
            qn = qn - torch.linalg.solve(eye / h - 0.5 * dfdq, r)
        return qn

    def trajectory(self, u):
        """The state history [nsteps+1, 4] from rest."""
        q = u.new_zeros(4)
        qs = [q]
        for i in range(self.nvars):
            q = self._step(q, self.h[i], u[i])
            qs.append(q)
        return torch.stack(qs)

    # -- Problem surface -----------------------------------------------------
    def objective(self, x):
        return self.fobj_scale * torch.sum(self.h * x ** 2)

    def constraints(self, x):
        return self.con_scale * (self.trajectory(x)[-1] - self.qtarget)

    def get_vars_and_bounds(self):
        kw = dict(dtype=self._dtype, device=self._device)
        n = self.nvars
        return (torch.ones(n, **kw), torch.full((n,), -20.0, **kw),
                torch.full((n,), 20.0, **kw))
