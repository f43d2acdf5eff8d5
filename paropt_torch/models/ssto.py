"""SSTO lunar ascent by trapezoidal collocation, the second dymos-role
trajectory (counterpart of paropt_tpu/models/ssto.py, where the reference's
example and its equations are described).

A 2-D vehicle (states x, y, vx, vy, m; launch values eliminated) under
constant thrust with linear-tangent guidance tan θ(τ) = p0 (1 - τ) + p1 τ
over normalized phase time; the 5(N-1) banded defects / 100 are general-CSR
equalities, the final y, vx and vy three dense equalities; minimize
0.01·tf.  Variables carry the reference's scalings (1000 for x and y, 100
for vx, vy and m).
"""

from __future__ import annotations

import numpy as np
import torch

from ..dtypes import resolve_dtype
from ..problem import CSRSparseProblem

__all__ = ["SSTOCollocation"]

_G = 1.61544                    # lunar gravity, m/s^2
_THRUST = 3.0 * 50000.0 * _G    # N
_ISP = 1.0e6                    # s
_M0 = 50000.0                   # kg launch mass
_REF_XY = 1000.0
_REF_V = 100.0                  # for vx, vy and m
_DEFECT_REF = 100.0
_YF, _VXF, _VYF = 1.85e5, 1627.0, 0.0
_STATES = ("x", "y", "vx", "vy", "m")


class SSTOCollocation(CSRSparseProblem):
    """Trapezoidal-collocation SSTO lunar ascent (the dymos example's
    configuration).  Takes ``dtype`` and ``device`` (None: the card)."""

    def __init__(self, n_nodes: int = 40, dtype=None, device=None):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        N = int(n_nodes)
        if N < 4:
            raise ValueError("n_nodes must be at least 4")
        self.N = N
        self._dtype = resolve_dtype(dtype)

        # scaled layout: x_1..x_{N-1} | y | vx | vy | m (each N-1) | p0 p1 | tf
        nb = N - 1
        self._off = {s: i * nb for i, s in enumerate(_STATES)}
        self._op = 5 * nb
        self._otf = 5 * nb + 2
        nvars = 5 * nb + 3

        rowp, cols = [0], []

        def add_row(cset):
            cols.extend(sorted(set(cset)))
            rowp.append(len(cols))

        tail = [self._op, self._op + 1, self._otf]   # p0, p1, tf
        for i in range(N - 1):
            def pair(s):
                return [self._off[s] + j - 1 for j in (i, i + 1) if j >= 1]
            vx2, vy2, m2 = pair("vx"), pair("vy"), pair("m")
            add_row(pair("x") + vx2 + [self._otf])
            add_row(pair("y") + vy2 + [self._otf])
            add_row(vx2 + m2 + tail)
            add_row(vy2 + m2 + tail)
            add_row(m2 + [self._otf])
        super().__init__(nvars=nvars, ncon=3,
                         rowp=np.asarray(rowp, np.int32),
                         cols=np.asarray(cols, np.int32),
                         ninequality=0, nwinequality=0, device=device)
        # normalized phase time, computed as the JAX package does (in
        # float64, then cast)
        self._tau = torch.as_tensor(np.linspace(0.0, 1.0, N),
                                    device=self._device)
        self._jac_fill = self.colored_jacobian_fill(self._defects)

    # -- trajectory assembly ---------------------------------------------
    def _full_states(self, xv):
        """Physical-unit state arrays [N] (launch values first), the θ of
        each node and tf."""
        nb = self.N - 1

        def full(s, ref, s0=0.0):
            o = self._off[s]
            return torch.cat([xv.new_tensor([s0]), ref * xv[o:o + nb]])

        p0, p1 = xv[self._op], xv[self._op + 1]
        tau = self._tau.to(xv.dtype)
        theta = torch.atan(p0 * (1.0 - tau) + p1 * tau)
        return (full("x", _REF_XY), full("y", _REF_XY), full("vx", _REF_V),
                full("vy", _REF_V, 1e-6), full("m", _REF_V, _M0), theta,
                xv[self._otf])

    def _defects(self, xv):
        """[5(N-1)] trapezoidal defects / defect_ref, interleaved."""
        xs, ys, vx, vy, m, th, tf = self._full_states(xv)
        h = tf / (self.N - 1)
        ct, st = torch.cos(th), torch.sin(th)
        fvx = _THRUST * ct / m
        fvy = _THRUST * st / m - _G
        fm = torch.full_like(m, -_THRUST / (_G * _ISP))

        def defect(s, f):
            return (s[1:] - s[:-1] - 0.5 * h * (f[:-1] + f[1:])) \
                / _DEFECT_REF

        d = torch.stack([defect(xs, vx), defect(ys, vy), defect(vx, fvx),
                         defect(vy, fvy), defect(m, fm)], dim=1)
        return d.reshape(-1)

    # -- Problem surface -------------------------------------------------
    def objective(self, x):
        return 0.01 * x[self._otf]          # dymos scaler=0.01

    def constraints(self, x):
        """Final-state boundary equalities in the reference's scalings."""
        xs, ys, vx, vy, m, th, tf = self._full_states(x)
        return torch.stack([(ys[-1] - _YF) / 1.0e4,
                            (vx[-1] - _VXF) / _REF_V,
                            (vy[-1] - _VYF) / _REF_V])

    def sparse_constraints(self, x):
        return self._defects(x)

    def eval_sparse_jacobian_data(self, x):
        return self._jac_fill(x)

    def get_vars_and_bounds(self):
        N = self.N
        # dymos-style linear interpolation start
        start = np.concatenate([
            np.linspace(0.0, 350000.0, N)[1:] / _REF_XY,
            np.linspace(0.0, 185000.0, N)[1:] / _REF_XY,
            np.linspace(0.0, 1627.0, N)[1:] / _REF_V,
            np.linspace(1e-6, 0.0, N)[1:] / _REF_V,
            np.full(N - 1, _M0) / _REF_V, [0.5 * np.pi, 0.0], [500.0]])
        lb = np.concatenate([np.full(N - 1, -1.0) / _REF_XY,
                             np.zeros(N - 1), np.zeros(N - 1),
                             np.full(N - 1, -1e4) / _REF_V,
                             np.full(N - 1, 1.0) / _REF_V,
                             [-100.0, -100.0], [10.0]])
        ub = np.concatenate([np.full(N - 1, 1e7) / _REF_XY,
                             np.full(N - 1, 1e7) / _REF_XY,
                             np.full(N - 1, 1e4) / _REF_V,
                             np.full(N - 1, 1e4) / _REF_V,
                             np.full(N - 1, 1e6) / _REF_V,
                             [100.0, 100.0], [1000.0]])
        kw = dict(dtype=self._dtype, device=self._device)
        return tuple(torch.as_tensor(a, **kw) for a in (start, lb, ub))

    # -- reporting -------------------------------------------------------
    def final_time(self, x):
        return float(x[self._otf])

    def trajectory(self, x):
        xs, ys, vx, vy, m, th, tf = self._full_states(torch.as_tensor(x))
        t = np.linspace(0.0, float(tf), self.N)
        return (t,) + tuple(a.detach().cpu().numpy()
                            for a in (xs, ys, vx, vy, m, th))
