"""Brachistochrone by trapezoidal collocation, the dymos-role trajectory
problem (counterpart of paropt_tpu/models/brachistochrone.py, where the
transcription and the reference's dymos example are described).

N uniform nodes carry the states x, y, v (the boundary-fixed values
eliminated), the control θ and the final time tf; the 3(N-1) defects

    d_s[i] = s_{i+1} - s_i - h/2 (f_s(i) + f_s(i+1)),   h = tf/(N-1),
    xdot = v sin θ,  ydot = -v cos θ,  vdot = g cos θ,

are banded general-CSR equalities, so the solve takes the native sparse
factor; min tf.  The CSR values come from a colored forward-mode fill on
the device (`CSRSparseProblem.colored_jacobian_fill`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..dtypes import resolve_dtype
from ..problem import CSRSparseProblem

__all__ = ["BrachistochroneCollocation"]

_G = 9.80665
_DEG = np.pi / 180.0


class BrachistochroneCollocation(CSRSparseProblem):
    """Trapezoidal-collocation brachistochrone (the dymos example's
    configuration).  Takes ``dtype`` and ``device`` (None: the card)."""

    def __init__(self, n_nodes: int = 48, x0=(0.0, 10.0), xf=(10.0, 5.0),
                 v0: float = 0.0, g: float = _G, dtype=None, device=None):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        N = int(n_nodes)
        if N < 4:
            raise ValueError("n_nodes must be at least 4")
        self.N = N
        self.g = float(g)
        self.bc = (float(x0[0]), float(x0[1]), float(xf[0]), float(xf[1]),
                   float(v0))
        self._dtype = resolve_dtype(dtype)

        # variable layout (boundary-fixed states eliminated):
        #   x_1..x_{N-2} | y_1..y_{N-2} | v_1..v_{N-1} | th_0..th_{N-1} | tf
        self._ox, self._oy = 0, N - 2
        self._ov, self._ot = 2 * N - 4, 3 * N - 5
        self._otf = 4 * N - 5
        nvars = 4 * N - 4

        # one row per defect, (x, y, v) for each interval: a banded pattern
        rowp, cols = [0], []

        def add_row(node_cols):
            cols.extend(sorted(node_cols))
            rowp.append(len(cols))

        for i in range(N - 1):
            sx = [self._ox + j - 1 for j in (i, i + 1) if 1 <= j <= N - 2]
            sy = [self._oy + j - 1 for j in (i, i + 1) if 1 <= j <= N - 2]
            vs = [self._ov + j - 1 for j in (i, i + 1) if 1 <= j <= N - 1]
            ths = [self._ot + i, self._ot + i + 1]
            add_row(sx + vs + ths + [self._otf])
            add_row(sy + vs + ths + [self._otf])
            add_row(vs + ths + [self._otf])

        super().__init__(nvars=nvars, ncon=0,
                         rowp=np.asarray(rowp, np.int32),
                         cols=np.asarray(cols, np.int32), nwinequality=0,
                         device=device)
        self._jac_fill = self.colored_jacobian_fill(self._defects)

    # -- trajectory assembly ---------------------------------------------
    def _full_states(self, xv):
        """The full x, y, v, θ node arrays [N] and tf."""
        N = self.N
        x0, y0, xN, yN, v0 = self.bc
        xs = torch.cat([xv.new_tensor([x0]), xv[self._ox:self._ox + N - 2],
                        xv.new_tensor([xN])])
        ys = torch.cat([xv.new_tensor([y0]), xv[self._oy:self._oy + N - 2],
                        xv.new_tensor([yN])])
        vs = torch.cat([xv.new_tensor([v0]), xv[self._ov:self._ov + N - 1]])
        return xs, ys, vs, xv[self._ot:self._ot + N], xv[self._otf]

    def _defects(self, xv):
        """[3(N-1)] trapezoidal defects, interleaved (x, y, v)."""
        xs, ys, vs, th, tf = self._full_states(xv)
        h = tf / (self.N - 1)
        sin_t, cos_t = torch.sin(th), torch.cos(th)
        fx = vs * sin_t
        fy = -vs * cos_t
        fv = self.g * cos_t
        dx = xs[1:] - xs[:-1] - 0.5 * h * (fx[:-1] + fx[1:])
        dy = ys[1:] - ys[:-1] - 0.5 * h * (fy[:-1] + fy[1:])
        dv = vs[1:] - vs[:-1] - 0.5 * h * (fv[:-1] + fv[1:])
        return torch.stack([dx, dy, dv], dim=1).reshape(-1)

    # -- Problem surface -------------------------------------------------
    def objective(self, x):
        return x[self._otf]

    def sparse_constraints(self, x):
        return self._defects(x)

    def eval_sparse_jacobian_data(self, x):
        return self._jac_fill(x)

    def get_vars_and_bounds(self):
        N = self.N
        x0, y0, xN, yN, v0 = self.bc
        # dymos-style linear interpolation start
        start = np.concatenate([np.linspace(x0, xN, N)[1:-1],
                                np.linspace(y0, yN, N)[1:-1],
                                np.linspace(v0, 9.9, N)[1:],
                                np.linspace(5.0, 100.5, N) * _DEG, [2.0]])
        big = 1e3
        lb = np.concatenate([np.full(3 * N - 5, -big),
                             np.full(N, 0.01 * _DEG), [0.5]])
        ub = np.concatenate([np.full(3 * N - 5, big),
                             np.full(N, 179.9 * _DEG), [10.0]])
        kw = dict(dtype=self._dtype, device=self._device)
        return tuple(torch.as_tensor(a, **kw) for a in (start, lb, ub))

    # -- reporting -------------------------------------------------------
    def trajectory(self, x):
        """(t, x, y, v, θ) node arrays as numpy."""
        xs, ys, vs, th, tf = self._full_states(torch.as_tensor(x))
        t = np.linspace(0.0, float(tf), self.N)
        return (t,) + tuple(a.detach().cpu().numpy()
                            for a in (xs, ys, vs, th))
