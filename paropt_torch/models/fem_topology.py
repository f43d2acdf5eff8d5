"""2-D plane-stress SIMP topology optimization (counterpart of
paropt_tpu/models/fem_topology.py, where the model is documented).

Minimum-compliance design of an nex × ney bilinear-quad cantilever:

    min  f·u(x)          K(x) u = f,  E_e = Emin + xf_e^p (E0 − Emin)
    s.t. V − mean(xf) >= 0                    (volume, dense)
         cap − regionmean(x) >= 0             (per-region weighting, sparse)
         0 <= x <= 1

As in the JAX package: K u = f is solved matrix-free by CG with a fixed
iteration count, preconditioned by Jacobi or by a geometric-multigrid
V-cycle; the element product is a [ne, 8] @ [8, 8] matmul between corner
slices of the node grid and pads back onto it; the compliance gradient is
the self-adjoint one, dc/dx_e = −(dE/dx_e)·(u_eᵀ k0 u_e), taken from the
forward solve's u with no second solve and no autograd through CG
(`_Compliance`).  CG and the V-cycle read nothing on the host: the
breakdown guards are tensor ``where``s and the coarsest level is solved
with the factor of ``torch.linalg.cholesky_ex``.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import record_function

from ..dtypes import resolve_device, resolve_dtype
from ..ops.veclib import dot
from ..problem import Problem, SparseJacobian

__all__ = ["FEMTopology", "DMOFEMTopology"]


def _element_stiffness(nu: float = 0.3) -> np.ndarray:
    """8x8 bilinear quad plane-stress element stiffness (unit E, thickness).
    Standard closed form (e.g. Sigmund's 99-line layout)."""
    k = np.array([
        1 / 2 - nu / 6, 1 / 8 + nu / 8, -1 / 4 - nu / 12, -1 / 8 + 3 * nu / 8,
        -1 / 4 + nu / 12, -1 / 8 - nu / 8, nu / 6, 1 / 8 - 3 * nu / 8])
    KE = np.array([
        [k[0], k[1], k[2], k[3], k[4], k[5], k[6], k[7]],
        [k[1], k[0], k[7], k[6], k[5], k[4], k[3], k[2]],
        [k[2], k[7], k[0], k[5], k[6], k[3], k[4], k[1]],
        [k[3], k[6], k[5], k[0], k[7], k[2], k[1], k[4]],
        [k[4], k[5], k[6], k[7], k[0], k[1], k[2], k[3]],
        [k[5], k[4], k[3], k[2], k[1], k[0], k[7], k[6]],
        [k[6], k[3], k[4], k[1], k[2], k[7], k[0], k[5]],
        [k[7], k[2], k[1], k[4], k[3], k[6], k[5], k[0]]])
    return KE / (1.0 - nu ** 2)


# Element corner order (matches _element_stiffness): ll, lr, ur, ul.
_CORNERS2D = ((0, 0), (1, 0), (1, 1), (0, 1))


def _gather2d(u, nex, ney):
    """[..., ne, 8] element dof values via corner slices of the node grid
    (== u[..., edofs]); leading dims are a batch."""
    lead = u.shape[:-1]
    ug = u.reshape(lead + (nex + 1, ney + 1, 2))
    ue = torch.cat([ug[..., :-1, :-1, :], ug[..., 1:, :-1, :],
                    ug[..., 1:, 1:, :], ug[..., :-1, 1:, :]], dim=-1)
    return ue.reshape(lead + (nex * ney, 8))


def _scatter2d(fe, nex, ney):
    """Adjoint of _gather2d: sum [..., ne, 8] element-corner values into the
    [..., ndof] node vector via four pads (F.pad lists the last dim
    first)."""
    lead = fe.shape[:-2]
    fe = fe.reshape(lead + (nex, ney, 8))
    out = None
    for i, (a, b) in enumerate(_CORNERS2D):
        part = F.pad(fe[..., 2 * i:2 * i + 2], (0, 0, b, 1 - b, a, 1 - a))
        out = part if out is None else out + part
    return out.reshape(lead + (-1,))


def _along(ndim, axis, sl):
    """Index tuple taking ``sl`` along ``axis`` of an ndim-array."""
    idx = [slice(None)] * ndim
    idx[axis] = sl
    return tuple(idx)


def _interleave(c, axis):
    """Insert midpoints along `axis`: size k+1 -> 2k+1 (linear)."""
    n = c.shape[axis]
    lo = c.narrow(axis, 0, n - 1)
    hi = c.narrow(axis, 1, n - 1)
    mid = 0.5 * (lo + hi)
    st = torch.stack([lo, mid], dim=axis + 1)
    shp = list(c.shape)
    shp[axis] = 2 * (n - 1)
    st = st.reshape(shp)
    return torch.cat([st, c.narrow(axis, n - 1, 1)], dim=axis)


def _interleave_t(r, axis):
    """Transpose of `_interleave` along `axis`: size 2k+1 -> k+1.  Output j
    takes r[2j] and half of each neighbouring midpoint, r[2j ± 1]."""
    out = r[_along(r.dim(), axis, slice(0, None, 2))].clone()
    half = 0.5 * r[_along(r.dim(), axis, slice(1, None, 2))]
    m = half.shape[axis]
    out.narrow(axis, 0, m).add_(half)
    out.narrow(axis, 1, m).add_(half)
    return out


def _prolong2d(nexc, neyc):
    """Bilinear node-grid prolongation [(nexc+1)(neyc+1)*2] ->
    [(2nexc+1)(2neyc+1)*2], built from interleave reshapes (no gather)."""

    def prolong(c_flat):
        c = c_flat.reshape(nexc + 1, neyc + 1, 2)
        for ax in range(2):
            c = _interleave(c, ax)
        return c.reshape(-1)

    return prolong


def _restrict2d(nexc, neyc):
    """The transpose of `_prolong2d(nexc, neyc)` (the multigrid
    restriction; JAX takes it with `jax.linear_transpose`)."""

    def restrict(r_flat):
        r = r_flat.reshape(2 * nexc + 1, 2 * neyc + 1, 2)
        for ax in (1, 0):
            r = _interleave_t(r, ax)
        return r.reshape(-1)

    return restrict


class _Compliance(torch.autograd.Function):
    """c(x) = f·u with K(E(x)) u = f, for a model that gives
    ``_state(x) -> (c, u)`` and ``_compliance_vjp(x, u, ct)``.  The backward
    reuses the forward's u.  ``forward`` takes no ctx and ``setup_context``
    is separate: the form ``torch.func.grad`` accepts; under
    ``torch.func.vmap`` (a batched solve) PyTorch runs forward and backward
    batched (``generate_vmap_rule``)."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x, model):
        return model._state(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, model = inputs
        _, u = output
        ctx.mark_non_differentiable(u)
        ctx.save_for_backward(x, u)
        ctx.model = model

    @staticmethod
    def backward(ctx, ct, _):
        x, u = ctx.saved_tensors
        return ctx.model._compliance_vjp(x, u, ct), None


class FEMTopology(Problem):
    """The 2-D SIMP compliance problem.  ``device`` holds every array; the
    constructor turns TF32 off for float32 matrix products, without which
    the SIMP CG diverges (the JAX package needs Precision.HIGHEST)."""

    def __init__(self, nex: int = 32, ney: int = 16,
                 volume_fraction: float = 0.4, penal: float = 3.0,
                 emin: float = 1e-3, e0: float = 1.0,
                 region: int = 0, region_cap: float = 0.8,
                 filter_radius: int = 1, cg_iters: int = 200,
                 solver: str = "jacobi", mg_smooth: int = 2,
                 mg_omega: float = 0.5, dtype=None, seed: int = 0,
                 device=None):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        ne = nex * ney
        nwcon = 0
        if region > 0:
            if ne % region:
                raise ValueError("nex * ney must be a multiple of region")
            nwcon = ne // region
        super().__init__(nvars=ne, ncon=1, nwcon=nwcon, nwblock=1)
        dt = resolve_dtype(dtype)
        self._dtype = dt
        self._device = resolve_device(device)
        self.nex, self.ney = nex, ney
        self.volume_fraction = volume_fraction
        self.penal = penal
        self.emin, self.e0 = emin, e0
        self.region = region
        self.region_cap = region_cap
        self.rfil = filter_radius
        self.cg_iters = cg_iters

        # node numbering: (nex+1) x (ney+1), dof = 2*node
        nnx, nny = nex + 1, ney + 1
        self.ndof = 2 * nnx * nny
        ex, ey = np.meshgrid(np.arange(nex), np.arange(ney), indexing="ij")
        n1 = (ex * nny + ey).ravel()          # lower-left node of element
        # element node order: ll, lr, ur, ul
        nodes = np.stack([n1, n1 + nny, n1 + nny + 1, n1 + 1], axis=1)
        edofs = np.stack([2 * nodes[:, j // 2] + (j % 2)
                          for j in range(8)], axis=1)
        self.edofs = torch.as_tensor(edofs, dtype=torch.long,
                                     device=self._device)
        self.KE = self._tensor(_element_stiffness())
        self._ke_diag = torch.diagonal(self.KE)

        # cantilever: left edge fixed, downward load at right-mid node
        fixed = np.concatenate([[2 * j, 2 * j + 1] for j in range(nny)])
        self.free = torch.as_tensor(np.setdiff1d(np.arange(self.ndof), fixed),
                                    dtype=torch.long, device=self._device)
        mask = np.zeros(self.ndof)
        mask[fixed] = 1.0
        self.fixed_mask = self._tensor(mask)
        f = np.zeros(self.ndof)
        load_node = nex * nny + nny // 2
        f[2 * load_node + 1] = -1.0
        self.f = self._tensor(f)

        if region > 0:
            cols = np.arange(ne, dtype=np.int32).reshape(nwcon, region)
            vals = -np.full((nwcon, region), 1.0 / region)
            self._jac = SparseJacobian(ne, cols, self._tensor(vals),
                                       nwblock=1)

        # geometric-multigrid hierarchy (static: level dims, fixed masks,
        # prolongators); coarsen 2x while both element counts stay even
        if solver not in ("jacobi", "mgcg"):
            raise ValueError(f"solver must be 'jacobi' or 'mgcg': {solver!r}")
        self.solver = solver
        self.mg_smooth = mg_smooth
        self.mg_omega = mg_omega
        dims = [(nex, ney)]
        while (dims[-1][0] % 2 == 0 and dims[-1][1] % 2 == 0
               and dims[-1][0] >= 4 and dims[-1][1] >= 4):
            dims.append((dims[-1][0] // 2, dims[-1][1] // 2))
        self._mg_dims = dims
        if solver == "mgcg" and len(dims) == 1:
            warnings.warn(
                f"mesh {nex}x{ney} cannot coarsen (element counts must be "
                "even and >= 4): solver='mgcg' falls back to Jacobi-CG — "
                f"cg_iters={cg_iters} sized for multigrid will NOT "
                "converge the state solve; use hundreds of iterations or "
                "an even mesh", stacklevel=2)
        # level 0 reuses the model's own Dirichlet mask; coarser levels
        # apply the same rule (left-edge nodes) on the coarse node grids
        self._mg_fixed = [self.fixed_mask]
        for cx, cy in dims[1:]:
            m = np.zeros(2 * (cx + 1) * (cy + 1))
            m[:2 * (cy + 1)] = 1.0          # left-edge (i == 0) nodes
            self._mg_fixed.append(self._tensor(m))
        self._mg_prolong = [_prolong2d(cx, cy) for cx, cy in dims[1:]]
        self._mg_restrict = [_restrict2d(cx, cy) for cx, cy in dims[1:]]

        # normalize the objective by the initial compliance so the volume
        # multiplier is O(1) and well inside the elastic penalty gamma
        x0 = torch.full((ne,), volume_fraction, dtype=dt,
                        device=self._device)
        self.c_scale = 1.0 / float(self._compliance(self._filter(x0)))

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=self._dtype, device=self._device)

    # -- filter ---------------------------------------------------------
    def _filter(self, x):
        """Five-point average with periodic wrap (torch.roll, as jnp.roll
        in the JAX model)."""
        if self.rfil <= 0:
            return x
        xg = x.reshape(self.nex, self.ney)
        acc = xg
        cnt = torch.ones_like(xg)
        for dx, dy in ((1, 0), (-1, 0), (0, 1), (0, -1)):
            acc = acc + torch.roll(xg, (dx, dy), dims=(0, 1))
            cnt = cnt + 1.0
        return (acc / cnt).reshape(-1)

    # -- element gather/scatter ------------------------------------------
    def _gather_elem(self, u):
        """[ne, 8] element dof values via corner slices (== u[self.edofs])."""
        return _gather2d(u, self.nex, self.ney)

    def _scatter_elem(self, fe):
        """Adjoint of _gather_elem."""
        return _scatter2d(fe, self.nex, self.ney)

    # -- FEM ------------------------------------------------------------
    def _kmul(self, E, u):
        """K(E) @ u, matrix-free: slice element dofs off the node grid,
        batch 8x8 matmul, pad-add back; fixed dofs carry identity."""
        fe = (self._gather_elem(u) @ self.KE) * E[:, None]
        return torch.where(self.fixed_mask > 0, u, self._scatter_elem(fe))

    def _solve(self, E):
        """Preconditioned CG on K(E) u = f (fixed iteration count)."""
        with record_function("paropt.fem.solve"):
            return self._cg(E, self.f)

    # -- geometric multigrid ----------------------------------------------
    def _kmul_level(self, El, u, cx, cy, fixed):
        """K(E_l) @ u on MG level (cx, cy) with symmetric Dirichlet
        handling: zero on entry, identity on exit (so the assembled coarse
        matrix is SPD).  u may carry leading batch dims."""
        u0 = torch.where(fixed > 0, 0.0, u)
        fe = (_gather2d(u0, cx, cy) @ self.KE) * El[:, None]
        return torch.where(fixed > 0, u, _scatter2d(fe, cx, cy))

    def _mg_setup(self, E):
        """Per-level (E_l, diag_l) from the fine element moduli (2x2 mean
        pooling) + the Cholesky factor of the coarsest-level matrix,
        assembled by applying `_kmul_level` to the identity's columns."""
        Eg = E.reshape(self.nex, self.ney)
        levels = []
        for li, (cx, cy) in enumerate(self._mg_dims):
            El = Eg.reshape(-1)
            fixed = self._mg_fixed[li]
            diag = _scatter2d(self._ke_diag[None, :] * El[:, None], cx, cy)
            diag = torch.where(fixed > 0, 1.0, torch.clamp(diag, min=1e-12))
            levels.append((El, diag, fixed, cx, cy))
            if li + 1 < len(self._mg_dims):
                Eg = Eg.reshape(cx // 2, 2, cy // 2, 2).mean(dim=(1, 3))
        El, _, fixed, cx, cy = levels[-1]
        ndc = 2 * (cx + 1) * (cy + 1)
        eye = torch.eye(ndc, dtype=E.dtype, device=E.device)
        # row i of the batched product is K e_i: transpose to columns
        Kc = self._kmul_level(El, eye, cx, cy, fixed).T
        chol = torch.linalg.cholesky_ex(Kc).L
        return levels, chol

    def _mg_vcycle(self, levels, chol, r):
        """One symmetric V-cycle (weighted-Jacobi smoothing, bilinear
        transfer, dense coarse solve); SPD for fixed smoothing counts, so
        plain CG accepts it as preconditioner."""
        nu, om = self.mg_smooth, self.mg_omega

        def cycle(l, r):
            El, diag, fixed, cx, cy = levels[l]
            if l == len(levels) - 1:
                y = torch.linalg.solve_triangular(chol, r[:, None],
                                                  upper=False)
                e = torch.linalg.solve_triangular(chol.T, y, upper=True)
                return torch.where(fixed > 0, 0.0, e[:, 0])

            def kmul(v):
                return self._kmul_level(El, v, cx, cy, fixed)

            e = (om / diag) * r
            for _ in range(nu - 1):
                e = e + (om / diag) * (r - kmul(e))
            rc = self._mg_restrict[l](r - kmul(e))
            rc = torch.where(levels[l + 1][2] > 0, 0.0, rc)
            e = e + torch.where(fixed > 0, 0.0,
                                self._mg_prolong[l](cycle(l + 1, rc)))
            for _ in range(nu):
                e = e + (om / diag) * (r - kmul(e))
            return e

        return cycle(0, r)

    def _cg(self, E, b):
        """Preconditioned CG on K(E) u = b for a general RHS (fixed dofs
        are zeroed): Jacobi (solver='jacobi') or a geometric-multigrid
        V-cycle (solver='mgcg').  A fixed iteration count, and no value
        read on the host: the guards below are tensor ``where``s."""
        if self.solver == "mgcg" and len(self._mg_dims) > 1:
            levels, chol = self._mg_setup(E)      # carries per-level diags

            def precond(r):
                return self._mg_vcycle(levels, chol, r)
        else:
            diag = self._scatter_elem(self._ke_diag[None, :] * E[:, None])
            diag = torch.where(self.fixed_mask > 0, 1.0,
                               torch.clamp(diag, min=1e-12))

            def precond(r):
                return r / diag
        b = torch.where(self.fixed_mask > 0, 0.0, b)

        # the breakdown guard must be representable in the dtype: 1e-300
        # underflows to 0 in f32 and turns a rounded-to-zero curvature
        # into inf
        tiny = torch.finfo(self._dtype).tiny
        u = torch.zeros(self.ndof, dtype=self._dtype, device=self._device)
        r = b
        p = precond(b)
        rz = dot(b, p)
        for _ in range(self.cg_iters):
            Kp = self._kmul(E, p)
            pKp = dot(p, Kp)
            # rounded-to-nonpositive curvature: freeze instead of blowing up
            alpha = torch.where(pKp > tiny,
                                rz / torch.where(pKp > tiny, pKp, 1.0), 0.0)
            u = u + alpha * p
            r = r - alpha * Kp
            z = precond(r)
            rz_new = dot(r, z)
            # degenerate rz: restart with the steepest-descent direction
            beta = torch.where(rz > tiny,
                               rz_new / torch.where(rz > tiny, rz, 1.0), 0.0)
            p = z + beta * p
            rz = rz_new
        return u

    # -- compliance and its adjoint gradient ----------------------------
    def _simp(self, xf):
        return self.emin + xf ** self.penal * (self.e0 - self.emin)

    def _state(self, xf):
        u = self._solve(self._simp(xf))
        return dot(self.f, u), u

    def _element_energies(self, u):
        """u_e' k0 u_e for every element."""
        ue = self._gather_elem(u)
        return torch.sum((ue @ self.KE) * ue, dim=1)

    def _compliance_vjp(self, xf, u, ct):
        dE = self.penal * xf ** (self.penal - 1.0) * (self.e0 - self.emin)
        return -ct * dE * self._element_energies(u)

    def _compliance(self, xf):
        return _Compliance.apply(xf, self)[0]

    # -- Problem surface -------------------------------------------------
    def objective(self, x):
        return self.c_scale * self._compliance(self._filter(x))

    def constraints(self, x):
        return (self.volume_fraction - torch.mean(self._filter(x))).reshape(1)

    def sparse_constraints(self, x):
        # region caps act on the RAW densities, keeping the weighting
        # Jacobian exactly the block pattern
        rm = torch.mean(x.reshape(self.nwcon, self.region), dim=1)
        return self.region_cap - rm

    def sparse_jacobian(self, x):
        return self._jac

    def get_vars_and_bounds(self):
        kw = dict(dtype=self._dtype, device=self._device)
        ne = self.nvars
        return (torch.full((ne,), self.volume_fraction, **kw),
                torch.full((ne,), 1e-3, **kw), torch.ones(ne, **kw))


class DMOFEMTopology(Problem):
    """Multi-material (Discrete Material Optimization) 2-D compliance
    problem: per-element material weights with one "weights sum <= 1"
    constraint per element, so the sparse Jacobian is the partition
    ('blocked') pattern.

    Design x[e, m] ∈ [0, 1] (flattened element-major):
        E_e   = emin + Σ_m x[e,m]^p (E_m − emin)     (DMO interpolation)
        min   compliance(E)
        s.t.  mass_fraction − Σ_{e,m} ρ_m x[e,m]/ne  >= 0   (dense, ncon=1)
              1 − Σ_m x[e,m]                        >= 0   (per element)
    """

    def __init__(self, nex: int = 24, ney: int = 12,
                 e_mats=(1.0, 0.55, 0.25), rho_mats=(1.0, 0.5, 0.2),
                 mass_fraction: float = 0.3, penal: float = 3.0,
                 cg_iters: int = 300, solver: str = "jacobi", dtype=None,
                 device=None):
        dt = resolve_dtype(dtype)
        self.fem = FEMTopology(nex=nex, ney=ney, cg_iters=cg_iters,
                               solver=solver, dtype=dt, device=device)
        ne = nex * ney
        nmat = len(e_mats)
        super().__init__(nvars=ne * nmat, ncon=1, nwcon=ne, nwblock=1)
        self.ne, self.nmat = ne, nmat
        self._dtype = dt
        self._device = self.fem._device
        self.penal = penal
        self.mass_fraction = mass_fraction
        self.e_mats = self.fem._tensor(e_mats)
        self.rho_mats = self.fem._tensor(rho_mats)
        self.emin = self.fem.emin

        # partition-pattern weighting Jacobian: element e's row touches
        # columns [e*nmat, (e+1)*nmat), the 'blocked' layout
        cols = np.arange(ne * nmat, dtype=np.int32).reshape(ne, nmat)
        self._jac = SparseJacobian(ne * nmat, cols,
                                   self.fem._tensor(-np.ones((ne, nmat))),
                                   nwblock=1)
        x0, _, _ = self.get_vars_and_bounds()
        self.c_scale = 1.0 / float(self._compliance(x0))

    def _modulus(self, x):
        w = x.reshape(self.ne, self.nmat) ** self.penal
        return self.emin + w @ (self.e_mats - self.emin)

    def _state(self, x):
        u = self.fem._solve(self._modulus(x))
        return dot(self.fem.f, u), u

    def _compliance_vjp(self, x, u, ct):
        energies = self.fem._element_energies(u)               # [ne]
        xm = x.reshape(self.ne, self.nmat)
        dwdx = self.penal * xm ** (self.penal - 1.0)
        dE = dwdx * (self.e_mats - self.emin)[None, :]         # [ne, nmat]
        return (-ct * energies[:, None] * dE).reshape(-1)

    def _compliance(self, x):
        return _Compliance.apply(x, self)[0]

    # -- Problem surface -------------------------------------------------
    def objective(self, x):
        return self.c_scale * self._compliance(x)

    def constraints(self, x):
        mass = torch.mean(x.reshape(self.ne, self.nmat) @ self.rho_mats)
        return (self.mass_fraction - mass).reshape(1)

    def sparse_constraints(self, x):
        return 1.0 - torch.sum(x.reshape(self.ne, self.nmat), dim=1)

    def sparse_jacobian(self, x):
        return self._jac

    def get_vars_and_bounds(self):
        kw = dict(dtype=self._dtype, device=self._device)
        n = self.nvars
        return (torch.full((n,), self.mass_fraction / self.nmat, **kw),
                torch.full((n,), 1e-4, **kw), torch.ones(n, **kw))

    def material_field(self, x):
        """[ne] argmax material index (-1 where all weights ~ void)."""
        xm = x.detach().cpu().numpy().reshape(self.ne, self.nmat)
        idx = xm.argmax(axis=1)
        idx[xm.max(axis=1) < 0.3] = -1
        return idx
