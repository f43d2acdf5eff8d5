"""Callback-style problem adapter (counterpart of
paropt_tpu/drivers/callbacks.py).

The reference's primary usage mode is host callbacks into external physics
codes.  `FunctionProblem` wraps plain Python/numpy callables into the
`Problem` interface, no torch needed from the user; gradients may be
supplied or approximated by finite differences.  The drivers build on it.

`HostIO` is the host round trip of every callback problem (this one, the
drivers' adapters and `compat.Problem`): the solver's iterates stay on the
problem's device (the card unless the caller names another), a callback
reads x as a read-only float64 numpy array, and its outputs go back to the
device, each move counted by the problem's ``syncs``, which the host
`InteriorPoint` shares.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..dtypes import resolve_device
from ..ip import HostSyncs
from ..problem import Problem

__all__ = ["FunctionProblem", "HostIO"]


class HostIO:
    """The host round trips of a numpy-callback problem: ``syncs`` counts
    the reads and the bytes each way; ``_device`` holds the tensors."""

    def _host_io(self, device) -> None:
        self.syncs = HostSyncs()
        self._device = resolve_device(device)

    def _read(self, t) -> np.ndarray:
        """A device vector as a read-only float64 array (one counted
        read)."""
        a = self.syncs.array(torch.as_tensor(t)).astype(np.float64,
                                                        copy=False)
        a.flags.writeable = False
        return a

    def _put(self, a) -> torch.Tensor:
        return self.syncs.upload(np.asarray(a, dtype=np.float64),
                                 self._device)


class FunctionProblem(HostIO, Problem):
    """Problem from plain callables.

    ``x0``, ``lb``, ``ub``: arrays; ``objective``: f(x) -> float;
    ``gradient``: g(x) -> [n] (finite differences if omitted);
    ``constraints``: c(x) -> [ncon] with c >= 0 (optional); ``jacobian``:
    A(x) -> [ncon, n] (finite differences if omitted); ``ninequality``:
    the number of leading inequality constraints; ``fd_step``: the
    finite-difference step; ``device``: where the solver's tensors live
    (None: the card)."""

    def __init__(self, x0, lb, ub,
                 objective: Callable,
                 gradient: Optional[Callable] = None,
                 constraints: Optional[Callable] = None,
                 jacobian: Optional[Callable] = None,
                 ninequality: Optional[int] = None,
                 fd_step: float = 1e-7, device=None):
        x0 = np.asarray(x0, dtype=float)
        ncon = len(np.atleast_1d(constraints(x0))) if constraints else 0
        super().__init__(nvars=x0.shape[0], ncon=ncon,
                         ninequality=ninequality)
        self._host_io(device)
        self._x0 = x0
        self._lb = np.asarray(lb, dtype=float)
        self._ub = np.asarray(ub, dtype=float)
        self._f = objective
        self._g = gradient
        self._c = constraints
        self._J = jacobian
        self._h = fd_step
        self.neval = 0
        self.ngeval = 0

    def get_vars_and_bounds(self):
        return self._put(self._x0), self._put(self._lb), self._put(self._ub)

    def eval_obj_con(self, x):
        xnp = self._read(x)
        self.neval += 1
        f = float(self._f(xnp))
        c = (np.atleast_1d(self._c(xnp)).astype(float) if self._c
             else np.zeros(0))
        return self._put(f), self._put(c)

    def _fd_gradient(self, fn, xnp, fx):
        n = xnp.shape[0]
        fx = np.atleast_1d(np.asarray(fx, dtype=float))
        out = np.zeros((fx.shape[0], n))
        for i in range(n):
            xp = xnp.copy()
            xp[i] += self._h
            out[:, i] = (np.atleast_1d(fn(xp)) - fx) / self._h
        return out

    def eval_obj_con_gradient(self, x):
        xnp = self._read(x)
        self.ngeval += 1
        if self._g is not None:
            g = np.asarray(self._g(xnp), dtype=float)
        else:
            g = self._fd_gradient(self._f, xnp, self._f(xnp))[0]
        if self.ncon == 0:
            A = np.zeros((0, self.nvars))
        elif self._J is not None:
            A = np.asarray(self._J(xnp), dtype=float).reshape(self.ncon,
                                                              self.nvars)
        else:
            A = self._fd_gradient(self._c, xnp, self._c(xnp))
        return self._put(g), self._put(A)
