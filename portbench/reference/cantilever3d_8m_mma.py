"""Plain reference of the 3-D SIMP cantilever (`configs/cantilever3d_8m_mma.json`)
and of one MMA outer step on it.

The model: an nex x ney x nez grid of unit trilinear hexahedra, three
displacement dofs per node, every dof of the x = 0 face fixed, a load of
-1/(ney + 1) in z on each node of the bottom edge (z = 0) of the free face
(x = nex).  The design x (one density per element, C order over (x, y, z))
is smoothed by the 7-point average with periodic wrap (the element and its
six face neighbours, each axis wrapping around), E = emin + xf^p (e0 - emin),
and the objective is the compliance f.u of K(E) u = f, divided by the
compliance of the uniform design at the volume fraction.  The constraint is
V - mean(x) >= 0, and 0 <= x <= 1.

The state solve here is its own: conjugate gradients preconditioned by a
geometric multigrid V-cycle (2x coarsening while every element count is
even and at least 4, coarse moduli by 2x2x2 averaging times 2, damped
Jacobi smoothing, trilinear transfer, a dense Cholesky solve on the
coarsest grid), run until the recursive residual falls below `RTOL`; the
true residual is then computed and returned, so a reading says how well
the reference solved.

The MMA step is Svanberg's with ParOpt's coefficients (the asymptote
update, the move limit, the eps and delta regularization), and its
subproblem is solved exactly through its one-dimensional dual: each x_j is
a closed form of the volume multiplier, found by bisection.

numpy and torch only; nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch

from ._plain import Precision, full_precision_products

CORNERS = ((0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
           (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1))
RTOL = 1e-10
# the true relative residual a reference solve must reach to be used
TRUST = 1e-6
MAX_CG = 400
SMOOTH = 2
OMEGA = 0.5


def element_stiffness(nu: float) -> np.ndarray:
    """[24, 24] stiffness of the unit cube with E = 1: trilinear shape
    functions, 2 x 2 x 2 Gauss points, dof 3 * corner + component."""
    lam = nu / ((1.0 + nu) * (1.0 - 2.0 * nu))
    mu = 0.5 / (1.0 + nu)
    D = np.full((3, 3), lam) + 2.0 * mu * np.eye(3)
    D = np.block([[D, np.zeros((3, 3))], [np.zeros((3, 3)), mu * np.eye(3)]])
    sign = 2.0 * np.array(CORNERS, dtype=float) - 1.0      # [8, 3], +-1
    ke = np.zeros((24, 24))
    for q in np.array(np.meshgrid(*[[-1, 1]] * 3, indexing="ij")).reshape(3, 8).T:
        pt = q / np.sqrt(3.0)
        # dN_i / d(local) at pt, local in [-1, 1]^3; d(local)/dx = 2
        f = 1.0 + sign * pt                                # [8, 3]
        dN = np.stack([sign[:, 0] * f[:, 1] * f[:, 2],
                       f[:, 0] * sign[:, 1] * f[:, 2],
                       f[:, 0] * f[:, 1] * sign[:, 2]], axis=1) / 8.0 * 2.0
        B = np.zeros((6, 24))
        for i in range(8):
            dx, dy, dz = dN[i]
            B[0, 3 * i] = dx
            B[1, 3 * i + 1] = dy
            B[2, 3 * i + 2] = dz
            B[3, 3 * i + 1], B[3, 3 * i + 2] = dz, dy      # yz
            B[4, 3 * i], B[4, 3 * i + 2] = dz, dx          # xz
            B[5, 3 * i], B[5, 3 * i + 1] = dy, dx          # xy
        ke += B.T @ D @ B / 8.0                            # |J| = 1/8
    return ke


class Cantilever3D:
    """The model of the module docstring in one precision."""

    def __init__(self, nex, ney, nez, volume_fraction=0.3, penal=3.0,
                 emin=1e-3, e0=1.0, nu=0.3, precision="float64",
                 device="cpu"):
        full_precision_products()
        self.p = Precision(precision)
        self.kw = dict(dtype=self.p.dtype, device=device)
        self.dims = [(nex, ney, nez)]
        while all(d % 2 == 0 and d >= 4 for d in self.dims[-1]):
            self.dims.append(tuple(d // 2 for d in self.dims[-1]))
        self.volume_fraction = volume_fraction
        self.penal, self.emin, self.e0 = penal, emin, e0
        self.ke = torch.as_tensor(element_stiffness(nu), **self.kw)
        f = torch.zeros((nex + 1, ney + 1, nez + 1, 3), **self.kw)
        f[nex, :, 0, 2] = -1.0 / (ney + 1)
        self.f = f
        uniform = torch.full((nex * ney * nez,), volume_fraction, **self.kw)
        self.c_scale = 1.0 / self.compliance(self.filter(uniform))[0]

    # -- design field ----------------------------------------------------
    def filter(self, x):
        g = x.reshape(self.dims[0]).to(self.p.dtype)
        acc = g.clone()
        for ax in range(3):
            acc = acc + torch.roll(g, 1, ax) + torch.roll(g, -1, ax)
        return (acc / 7.0).reshape(-1)

    def modulus(self, xf):
        return self.emin + xf ** self.penal * (self.e0 - self.emin)

    # -- operators on node grids [nnx, nny, nnz, 3] ------------------------
    def _elements(self, u):
        nx, ny, nz = (s - 1 for s in u.shape[:3])
        return torch.cat([u[a:a + nx, b:b + ny, c:c + nz]
                          for a, b, c in CORNERS], dim=-1).reshape(-1, 24)

    def _assemble(self, fe, shape):
        nx, ny, nz = (s - 1 for s in shape[:3])
        fe = fe.reshape(nx, ny, nz, 24)
        out = torch.zeros(shape, **self.kw)
        for i, (a, b, c) in enumerate(CORNERS):
            out[a:a + nx, b:b + ny, c:c + nz] += fe[..., 3 * i:3 * i + 3]
        return out

    def kmul(self, E, u):
        """K(E) u with the x = 0 nodes held at zero (rows and columns)."""
        u = u.clone()
        u[0] = 0.0
        out = self._assemble(self.p.mm(self._elements(u), self.ke)
                             * E.reshape(-1, 1), u.shape)
        out[0] = 0.0
        return out

    def diag(self, E, shape):
        d = torch.diagonal(self.ke)[None, :] * E.reshape(-1, 1)
        out = self._assemble(d, shape)
        out[0] = 1.0
        return out

    def energies(self, u):
        ue = self._elements(u)
        return torch.sum(self.p.mm(ue, self.ke) * ue, dim=1)

    # -- multigrid ---------------------------------------------------------
    @staticmethod
    def _prolong(c):
        for ax in range(3):
            n = c.shape[ax]
            lo, hi = c.narrow(ax, 0, n - 1), c.narrow(ax, 1, n - 1)
            shape = list(c.shape)
            shape[ax] = 2 * n - 1
            out = torch.empty(shape, dtype=c.dtype, device=c.device)
            idx = [slice(None)] * c.dim()
            idx[ax] = slice(0, None, 2)
            out[tuple(idx)] = c
            idx[ax] = slice(1, None, 2)
            out[tuple(idx)] = 0.5 * (lo + hi)
            c = out
        return c

    @staticmethod
    def _restrict(r):
        for ax in range(3):
            n = (r.shape[ax] + 1) // 2
            idx = [slice(None)] * r.dim()
            idx[ax] = slice(0, None, 2)
            out = r[tuple(idx)].clone()
            idx[ax] = slice(1, None, 2)
            half = 0.5 * r[tuple(idx)]
            out.narrow(ax, 0, n - 1).add_(half)
            out.narrow(ax, 1, n - 1).add_(half)
            r = out
        return r

    def _levels(self, E):
        levels = []
        for i, (nx, ny, nz) in enumerate(self.dims):
            shape = (nx + 1, ny + 1, nz + 1, 3)
            levels.append((E, self.diag(E, shape)))
            if i + 1 < len(self.dims):
                E = 2.0 * E.reshape(nx // 2, 2, ny // 2, 2, nz // 2, 2).mean(
                    dim=(1, 3, 5))
        Ec = levels[-1][0]
        nx, ny, nz = self.dims[-1]
        nd = 3 * (nx + 1) * (ny + 1) * (nz + 1)
        cols = torch.stack([self.kmul(Ec, e.reshape(nx + 1, ny + 1, nz + 1, 3))
                            .reshape(-1)
                            for e in torch.eye(nd, **self.kw)], dim=1)
        fixed = torch.zeros((nx + 1, ny + 1, nz + 1, 3), **self.kw)
        fixed[0] = 1.0
        cols = cols + torch.diag(fixed.reshape(-1))
        chol = torch.linalg.cholesky(0.5 * (cols + cols.T))
        return levels, chol

    def _vcycle(self, levels, chol, r, lvl=0):
        E, d = levels[lvl]
        if lvl == len(levels) - 1:
            e = torch.cholesky_solve(r.reshape(-1, 1), chol).reshape(r.shape)
            e[0] = 0.0
            return e
        e = OMEGA * r / d
        for _ in range(SMOOTH - 1):
            e = e + OMEGA * (r - self.kmul(E, e)) / d
        rc = self._restrict(r - self.kmul(E, e))
        rc[0] = 0.0
        ec = self._prolong(self._vcycle(levels, chol, rc, lvl + 1))
        ec[0] = 0.0
        e = e + ec
        for _ in range(SMOOTH):
            e = e + OMEGA * (r - self.kmul(E, e)) / d
        return e

    def solve(self, E):
        """(u, true relative residual, CG iterations) of K(E) u = f."""
        levels, chol = self._levels(E)
        b = self.f.clone()
        b[0] = 0.0
        u = torch.zeros_like(b)
        r = b.clone()
        z = self._vcycle(levels, chol, r)
        p = z.clone()
        rz = torch.sum(r * z)
        bnorm = torch.linalg.norm(b)
        its = 0
        for its in range(1, MAX_CG + 1):
            Kp = self.kmul(E, p)
            alpha = rz / torch.sum(p * Kp)
            u = u + alpha * p
            r = r - alpha * Kp
            if float(torch.linalg.norm(r) / bnorm) < RTOL:
                break
            z = self._vcycle(levels, chol, r)
            rz_new = torch.sum(r * z)
            p = z + (rz_new / rz) * p
            rz = rz_new
        relres = float(torch.linalg.norm(b - self.kmul(E, u)) / bnorm)
        return u, relres, its

    def compliance(self, xf):
        """(f.u, u, true relative residual) at a filtered design."""
        u, relres, _ = self.solve(self.modulus(xf).reshape(self.dims[0]))
        return float(torch.sum(self.f * u)), u, relres

    def evaluate(self, x):
        """(objective, gradient, volume constraint, true relative residual)
        at the design x."""
        xf = self.filter(x)
        c, u, relres = self.compliance(xf)
        dE = self.penal * xf ** (self.penal - 1.0) * (self.e0 - self.emin)
        grad = self.c_scale * self.filter(-dE * self.energies(u))
        vol = self.volume_fraction - float(torch.mean(x.to(self.p.dtype)))
        return self.c_scale * c, grad, vol, relres


# ---------------------------------------------------------------------------
# the MMA step
# ---------------------------------------------------------------------------


def asymptotes(xs, opts):
    """(L, U) of every outer iteration k = 0..len(xs)-1 from the iterates
    xs[0..k] (ParOpt's rule: the initial offset for k < 2, then contract
    where the last two moves changed sign and relax elsewhere, inside
    [min, max] offsets of the move interval)."""
    ml, off0 = opts["mma_move_limit"], opts["mma_init_asymptote_offset"]
    out = []
    L = U = None
    for k, x in enumerate(xs):
        lower = torch.clamp(x - ml, min=0.0)
        upper = torch.clamp(x + ml, max=1.0)
        if k < 2:
            L = x - off0 * (upper - lower)
            U = x + off0 * (upper - lower)
        else:
            x1, x2 = xs[k - 1], xs[k - 2]
            intrvl = torch.clamp(upper - lower, 0.01, 100.0)
            fac = torch.where((x - x1) * (x1 - x2) < 0.0,
                              opts["mma_asymptote_contract"],
                              opts["mma_asymptote_relax"])
            lo = opts["mma_min_asymptote_offset"] * intrvl
            hi = opts["mma_max_asymptote_offset"] * intrvl
            L = torch.clamp(torch.minimum(x - fac * (x1 - L), x - lo),
                            min=x - hi)
            U = torch.clamp(torch.maximum(x + fac * (U - x1), x + lo),
                            max=x + hi)
        out.append((L, U))
    return out


def mma_step(x, L, U, grad, vol, opts, bisections=200):
    """The exact solution of the MMA subproblem at x, in x's dtype: min
    sum p0/(U - y) + q0/(y - L) subject to the convex approximation of the
    volume constraint, alpha <= y <= beta."""
    n = x.numel()
    ml = opts["mma_move_limit"]
    eps, delta = opts["mma_eps_regularization"], opts["mma_delta_regularization"]
    lower = torch.clamp(x - ml, min=0.0)
    upper = torch.clamp(x + ml, max=1.0)
    alpha = torch.maximum(torch.maximum(lower, 0.9 * L + 0.1 * x),
                          x - 0.5 * (upper - lower))
    beta = torch.minimum(torch.minimum(upper, 0.9 * U + 0.1 * x),
                         x + 0.5 * (upper - lower))
    gp, gn = torch.clamp(grad, min=0.0), torch.clamp(-grad, min=0.0)
    p0 = (U - x) ** 2 * ((1.0 + delta) * gp + delta * gn + eps / (U - L))
    q0 = (x - L) ** 2 * ((1.0 + delta) * gn + delta * gp + eps / (U - L))
    # the volume constraint's gradient is -1/n everywhere: its MMA
    # approximation is sum pi / (U - y) + b <= 0 with
    pi = (U - x) ** 2 / n
    b = -(vol + torch.sum((U - x) / n))
    sq = torch.sqrt(q0)

    def y_of(lam):
        sp = torch.sqrt(p0 + lam * pi)
        return torch.clamp((sp * L + sq * U) / (sp + sq), alpha, beta)

    def h(lam):
        return float(torch.sum(pi / (U - y_of(lam))) + b)

    if h(0.0) <= 0.0:
        return y_of(0.0)
    lo, hi = 0.0, 1.0
    while h(hi) > 0.0:
        lo, hi = hi, 2.0 * hi
    for _ in range(bisections):
        mid = 0.5 * (lo + hi)
        if h(mid) > 0.0:
            lo = mid
        else:
            hi = mid
        if hi - lo <= 1e-15 * hi:
            break
    return y_of(hi)
