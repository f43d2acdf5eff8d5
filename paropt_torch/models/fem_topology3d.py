"""3-D SIMP voxel topology optimization (counterpart of
paropt_tpu/models/fem_topology3d.py, where the model is documented).

Minimum-compliance design of an nex × ney × nez cantilever of 8-node
hexahedral voxels (3 dofs per node), fixed at the x = 0 face, loaded along
the bottom edge of the free face:

    min  f·u(x)          K(x) u = f,  E_e = Emin + xf_e^p (E0 − Emin)
    s.t. V − mean(x) >= 0                     (volume, dense)
         cap − regionmean(x) >= 0             (per-region caps, sparse)
         0 <= x <= 1

As in the JAX package: the state solve runs on SoA component grids
[3, nnx, nny, nnz], by CG with a fixed iteration count, preconditioned by
Jacobi or by a geometric-multigrid V-cycle whose coarsest level is a dense
Cholesky solve; the density filter is the 6-neighbour average with periodic
wrap (``torch.roll``, as ``jnp.roll``); the compliance gradient is the
self-adjoint one (`_Compliance`), taken from the u that ``eval_obj_con``
solved at the same point, with no solve of its own (`_StateMemo`), or
from its own forward solve where it is called alone.  Nothing in CG or the
V-cycle reads a value on the host.

The element product K(E)·u has two layouts, chosen per multigrid level:

- ``grid``: the eight corner-shifted slices of the component grids are
  stacked into [24, ne], multiplied by the [24, 24] element stiffness in one
  matmul, scaled by E and added back onto the node grid through eight
  in-place slice adds (the JAX package's 576-term scalar stencil computes
  the same function, but eager PyTorch would launch each term);
- ``aos``: the JAX package's [ne, 24] form: gather to element rows, one
  [ne, 24] @ [24, 24] matmul, eight pads back.

``layout="auto"`` takes the grid form where the node grid's minor dimension
is at least `_GRID_MIN_NNZ`, a cutoff chosen from both forms' times on the
H100 (chip_smoke.py phase 18 times both per level): every level, as
measured there.

On a sharded design vector each rank evaluates on its x-slab of the
voxel grid (`_FEM3DStrip`, `parallel.halo`), with halos along x only.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch
import torch.nn.functional as F

from ..dtypes import resolve_device, resolve_dtype
from ..ops.veclib import dot
from ..parallel import halo
from ..parallel.halo import strip_evaluations
from ..problem import Problem, SparseJacobian
from ..utils.spans import span
from .fem_topology import (_Compliance, _fields_of, _interleave,
                           _interleave_t, _StateMemo, _view_of,
                           mg_gather_level)

__all__ = ["FEMTopology3D", "DMOFEMTopology3D", "hex_element_stiffness"]

# layout="auto": the grid form where the node grid's minor dimension
# (nnz = nez + 1) is at least this, the [ne, 24] form below it.  On the H100
# the grid form won at every level of the 160x80x80 hierarchy (nnz 6 to 81),
# 1.6-2.5x in device time with 17-18 kernels per product against 31-33
# (chip_smoke.py phase 18; PERF.md), so every level takes it
_GRID_MIN_NNZ = 2


def hex_element_stiffness(nu: float = 0.3) -> np.ndarray:
    """[24, 24] stiffness of a unit-cube 8-node hex with E = 1 (standard
    isoparametric 2x2x2 Gauss quadrature)."""
    nodes = np.array([[-1, -1, -1], [1, -1, -1], [1, 1, -1], [-1, 1, -1],
                      [-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1]],
                     dtype=float)
    # isotropic elasticity (Voigt: xx, yy, zz, yz, xz, xy)
    lam = nu / ((1 + nu) * (1 - 2 * nu))
    mu = 1.0 / (2 * (1 + nu))
    D = np.zeros((6, 6))
    D[:3, :3] = lam
    D[0, 0] = D[1, 1] = D[2, 2] = lam + 2 * mu
    D[3, 3] = D[4, 4] = D[5, 5] = mu

    g = 1.0 / np.sqrt(3.0)
    KE = np.zeros((24, 24))
    for gx in (-g, g):
        for gy in (-g, g):
            for gz in (-g, g):
                # dN/dxi at the gauss point; unit cube => dxi/dx = 2
                dN = np.zeros((3, 8))
                for i, (xi, eta, zeta) in enumerate(nodes):
                    dN[0, i] = xi * (1 + eta * gy) * (1 + zeta * gz) / 8.0
                    dN[1, i] = (1 + xi * gx) * eta * (1 + zeta * gz) / 8.0
                    dN[2, i] = (1 + xi * gx) * (1 + eta * gy) * zeta / 8.0
                dN = 2.0 * dN  # to physical coords
                B = np.zeros((6, 24))
                for i in range(8):
                    B[0, 3 * i + 0] = dN[0, i]
                    B[1, 3 * i + 1] = dN[1, i]
                    B[2, 3 * i + 2] = dN[2, i]
                    B[3, 3 * i + 1] = dN[2, i]
                    B[3, 3 * i + 2] = dN[1, i]
                    B[4, 3 * i + 0] = dN[2, i]
                    B[4, 3 * i + 2] = dN[0, i]
                    B[5, 3 * i + 0] = dN[1, i]
                    B[5, 3 * i + 1] = dN[0, i]
                KE += (B.T @ D @ B) / 8.0  # detJ = 1/8, weight 1
    return KE


# Corner order matches hex_element_stiffness's local node ordering.
_CORNERS3D = ((0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
              (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1))


def _sl(a):
    return slice(1, None) if a else slice(None, -1)


def _to_grid3(u_flat, nnx, nny, nnz):
    """Flat AoS dof vectors [..., 3*nnx*nny*nnz] -> SoA component grids
    [..., 3, nnx, nny, nnz] (a view)."""
    lead = u_flat.shape[:-1]
    return u_flat.reshape(lead + (nnx, nny, nnz, 3)).movedim(-1, -4)


def _from_grid3(ug):
    """Inverse of _to_grid3 (same dof ordering as the flat vector)."""
    return ug.movedim(-4, -1).reshape(ug.shape[:-4] + (-1,))


def _gather3d(u, nex, ney, nez):
    """[..., ne, 24] element dof values via corner slices of the node grid
    (== u[..., edofs])."""
    lead = u.shape[:-1]
    ug = u.reshape(lead + (nex + 1, ney + 1, nez + 1, 3))
    ue = torch.cat([ug[..., _sl(a), _sl(b), _sl(c), :]
                    for a, b, c in _CORNERS3D], dim=-1)
    return ue.reshape(lead + (nex * ney * nez, 24))


def _scatter3d(fe, nex, ney, nez):
    """Adjoint of _gather3d: sum [..., ne, 24] element-corner values into
    the [..., ndof] node vector through eight pads (F.pad lists the last
    dimension first)."""
    lead = fe.shape[:-2]
    fe = fe.reshape(lead + (nex, ney, nez, 24))
    out = None
    for i, (a, b, c) in enumerate(_CORNERS3D):
        part = F.pad(fe[..., 3 * i:3 * i + 3],
                     (0, 0, c, 1 - c, b, 1 - b, a, 1 - a))
        out = part if out is None else out + part
    return out.reshape(lead + (-1,))


def _same(t):
    return t


def _kmul_aos(KE, Eg, ug, fixed_g, zero_entry, node_sum=_same):
    """K(E) @ u in the [ne, 24] form, grid in and grid out; ``zero_entry``
    gives the symmetric-Dirichlet operator of the multigrid levels (zero on
    entry, identity on exit); ``node_sum`` completes the scattered node
    grid (a strip's halo)."""
    nex, ney, nez = Eg.shape
    ug0 = torch.where(fixed_g > 0, 0.0, ug) if zero_entry else ug
    ue = _gather3d(_from_grid3(ug0), nex, ney, nez)
    fe = (ue @ KE) * Eg.reshape(-1)[:, None]
    out = _to_grid3(_scatter3d(fe, nex, ney, nez), nex + 1, ney + 1,
                    nez + 1)
    return torch.where(fixed_g > 0, ug, node_sum(out))


def _energy_aos(KE, ug):
    """Per-element unit-modulus strain energies u_e' KE u_e in the
    [ne, 24] form, as an [nex, ney, nez] grid."""
    nnx, nny, nnz = ug.shape[-3:]
    ue = _gather3d(_from_grid3(ug), nnx - 1, nny - 1, nnz - 1)
    return torch.sum((ue @ KE) * ue, dim=-1).reshape(nnx - 1, nny - 1,
                                                     nnz - 1)


def _corner_stack(ug):
    """[..., 24, nex, ney, nez]: the eight corner-shifted slices of the
    component grids, row 3·corner + component (the element stiffness's
    ordering)."""
    return torch.cat([ug[..., :, _sl(a), _sl(b), _sl(c)]
                      for a, b, c in _CORNERS3D], dim=-4)


def _add_corners(fe, shape):
    """Adjoint of _corner_stack: the node-grid sum of [..., 24, nex, ney,
    nez] element-corner values, by eight in-place slice adds."""
    nex, ney, nez = fe.shape[-3:]
    out = fe.new_zeros(shape)
    for i, (a, b, c) in enumerate(_CORNERS3D):
        out[..., :, a:a + nex, b:b + ney, c:c + nez] += \
            fe[..., 3 * i:3 * i + 3, :, :, :]
    return out


def _kmul_grid(KE, Eg, ug, fixed_g, zero_entry, node_sum=_same):
    """K(E) @ u on SoA grids in a bounded number of launches: the corner
    stack [24, ne], one [24, 24] product over the channel axis, the scale
    by E and eight slice adds; the same function as _kmul_aos."""
    ug0 = torch.where(fixed_g > 0, 0.0, ug) if zero_entry else ug
    U = _corner_stack(ug0)
    fe = torch.matmul(KE, U.reshape(U.shape[:-4] + (24, -1)))
    fe = fe.reshape(U.shape) * Eg
    return torch.where(fixed_g > 0, ug,
                       node_sum(_add_corners(fe, ug.shape)))


def _energy_grid(KE, ug):
    """Per-element strain energies in the grid form (== _energy_aos)."""
    U = _corner_stack(ug)
    KU = torch.matmul(KE, U.reshape(U.shape[:-4] + (24, -1)))
    return torch.sum(KU.reshape(U.shape) * U, dim=-4)


def _diag_grid(KE, Eg, fixed_g, node_sum=_same):
    """diag(K(E)) on component grids; 1.0 at fixed dofs."""
    d = torch.diagonal(KE)[:, None, None, None] * Eg
    out = node_sum(_add_corners(d, fixed_g.shape))
    return torch.where(fixed_g > 0, 1.0, torch.clamp(out, min=1e-12))


def _prolong3d():
    """Trilinear prolongation of SoA grids [..., 3, nnxc, nnyc, nnzc] ->
    [..., 3, 2nexc+1, 2neyc+1, 2nezc+1], built from interleave reshapes."""

    def prolong(cg):
        nd = cg.dim()
        for ax in (nd - 3, nd - 2, nd - 1):
            cg = _interleave(cg, ax)
        return cg

    return prolong


def _restrict3d():
    """The transpose of `_prolong3d()` (the multigrid restriction; JAX takes
    it with `jax.linear_transpose`)."""

    def restrict(r):
        nd = r.dim()
        for ax in (nd - 1, nd - 2, nd - 3):
            r = _interleave_t(r, ax)
        return r

    return restrict


@strip_evaluations
class FEMTopology3D(_StateMemo, Problem):
    """Cantilever voxel design domain: fixed at the x = 0 face, unit
    downward load along the bottom edge of the free face.  ``device`` holds
    every array; the constructor turns TF32 off for float32 matrix
    products, without which the SIMP CG diverges."""

    def __init__(self, nex: int = 16, ney: int = 8, nez: int = 8,
                 volume_fraction: float = 0.3, penal: float = 3.0,
                 emin: float = 1e-3, e0: float = 1.0,
                 region: int = 0, region_cap: float = 0.8,
                 cg_iters: int = 400, filter_on: bool = True,
                 solver: str = "jacobi", mg_smooth: int = 2,
                 mg_omega: float = 0.4, layout: str = "auto", dtype=None,
                 device=None):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if layout not in ("auto", "grid", "aos"):
            raise ValueError(f"layout must be 'auto', 'grid' or 'aos': "
                             f"{layout!r}")
        if solver not in ("jacobi", "mgcg"):
            raise ValueError(f"solver must be 'jacobi' or 'mgcg': {solver!r}")
        ne = nex * ney * nez
        nwcon = 0
        if region > 0:
            if ne % region:
                raise ValueError("nex * ney * nez must be a multiple of "
                                 "region")
            nwcon = ne // region
        super().__init__(nvars=ne, ncon=1, nwcon=nwcon, nwblock=1)
        self.layout = layout
        self._dtype = resolve_dtype(dtype)
        self._device = resolve_device(device)
        self.nex, self.ney, self.nez = nex, ney, nez
        self.ne = ne
        self.penal = penal
        self.emin, self.e0 = emin, e0
        self.volume_fraction = volume_fraction
        self.region, self.region_cap = region, region_cap
        self.cg_iters = cg_iters
        self.filter_on = filter_on
        self.KE = self._tensor(hex_element_stiffness())

        # node numbering: node(i, j, k) for i <= nex, j <= ney, k <= nez
        nnx, nny, nnz = nex + 1, ney + 1, nez + 1
        self.ndof = 3 * nnx * nny * nnz

        def nid(i, j, k):
            return (i * nny + j) * nnz + k

        ii, jj, kk = np.meshgrid(np.arange(nex), np.arange(ney),
                                 np.arange(nez), indexing="ij")
        corners = np.stack([nid(ii + a, jj + b, kk + c)
                            for a, b, c in _CORNERS3D],
                           axis=-1).reshape(ne, 8)
        edofs = (3 * corners[:, :, None] + np.arange(3)).reshape(ne, 24)
        self.edofs = torch.as_tensor(edofs, dtype=torch.long,
                                     device=self._device)

        # fixed: all dofs on the x = 0 face
        fixed = np.zeros((nnx, nny, nnz, 3))
        fixed[0] = 1.0
        self.fixed_mask = self._tensor(fixed.reshape(-1))
        self._fixed_g = _to_grid3(self.fixed_mask, nnx, nny, nnz)

        # load: unit force in -z along the bottom edge (z = 0) of the free
        # face (x = nex)
        f = np.zeros((nnx, nny, nnz, 3))
        f[nex, :, 0, 2] = -1.0 / nny
        self.f = self._tensor(f.reshape(-1))

        if region > 0:
            cols = np.arange(ne, dtype=np.int32).reshape(nwcon, region)
            vals = -np.full((nwcon, region), 1.0 / region)
            self._jac = SparseJacobian(ne, cols, self._tensor(vals),
                                       nwblock=1)

        # geometric-multigrid hierarchy: coarsen 2x while all three element
        # counts stay even and >= 4
        self.solver = solver
        self.mg_smooth = mg_smooth
        self.mg_omega = mg_omega
        dims = [(nex, ney, nez)]
        while all(d % 2 == 0 and d >= 4 for d in dims[-1]):
            dims.append(tuple(d // 2 for d in dims[-1]))
        self._mg_dims = dims
        if solver == "mgcg" and len(dims) == 1:
            warnings.warn(
                f"mesh {nex}x{ney}x{nez} cannot coarsen (element counts "
                "must be even and >= 4): solver='mgcg' falls back to "
                f"Jacobi-CG — cg_iters={cg_iters} sized for multigrid "
                "will NOT converge the state solve; use hundreds of "
                "iterations or an even mesh", stacklevel=2)
        # level 0 reuses the model's own Dirichlet mask; coarser levels
        # apply the same rule (x == 0 face) on the coarse node grids
        self._mg_fixed = [self._fixed_g]
        for cx, cy, cz in dims[1:]:
            m = np.zeros((3, cx + 1, cy + 1, cz + 1))
            m[:, 0] = 1.0
            self._mg_fixed.append(self._tensor(m))
        self._prolong = _prolong3d()
        self._restrict = _restrict3d()

        x0 = torch.full((ne,), volume_fraction, dtype=self._dtype,
                        device=self._device)
        self.c_scale = 1.0 / float(self._compliance(self._filter(x0)))

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=self._dtype, device=self._device)

    # -- filter (6-neighbour average on the voxel grid) -------------------
    def _filter(self, x):
        if not self.filter_on:
            return x
        xg = x.reshape(self.nex, self.ney, self.nez)
        acc = xg
        cnt = torch.ones_like(xg)
        for ax in (0, 1, 2):
            for sh in (1, -1):
                acc = acc + torch.roll(xg, sh, dims=ax)
                cnt = cnt + 1.0
        return (acc / cnt).reshape(-1)

    # -- element gather/scatter ------------------------------------------
    def _gather_elem(self, u):
        """[ne, 24] element dof values via corner slices (== u[edofs])."""
        return _gather3d(u, self.nex, self.ney, self.nez)

    def _scatter_elem(self, fe):
        """Adjoint of _gather_elem."""
        return _scatter3d(fe, self.nex, self.ney, self.nez)

    # -- FEM -------------------------------------------------------------
    def _use_grid(self, nnz: int) -> bool:
        if self.layout != "auto":
            return self.layout == "grid"
        return nnz >= _GRID_MIN_NNZ

    def _kmul_g(self, Eg, ug, fixed_g, zero_entry):
        """K(E) @ u on SoA grids (leading batch dims allowed), in the
        layout of this level."""
        if self._use_grid(ug.shape[-1]):
            return _kmul_grid(self.KE, Eg, ug, fixed_g, zero_entry,
                              self._node_sum)
        return _kmul_aos(self.KE, Eg, ug, fixed_g, zero_entry,
                         self._node_sum)

    def _node_sum(self, g):
        """A scattered node grid [..., nnx, nny, nnz] made whole (the strip
        view adds the neighbours' parts of the shared x rows)."""
        return g

    def _dot(self, a, b):
        """<a, b> of two nodal grids or flat vectors (the strip view's
        sums its owned rows over the ranks)."""
        return dot(a, b)

    def _mean(self, t):
        """The mean of an element field (the strip view's over the
        ranks)."""
        return torch.mean(t)

    def _energy_g(self, ug):
        """Per-element strain-energy grid, in the layout of the fine
        level."""
        if self._use_grid(ug.shape[-1]):
            return _energy_grid(self.KE, ug)
        return _energy_aos(self.KE, ug)

    def _grid(self, u):
        return _to_grid3(u, self.nex + 1, self.ney + 1, self.nez + 1)

    def _kmul(self, E, u):
        """K(E) @ u on flat vectors; fixed dofs carry the identity."""
        Eg = E.reshape(self.nex, self.ney, self.nez)
        return _from_grid3(self._kmul_g(Eg, self._grid(u), self._fixed_g,
                                        zero_entry=False))

    # -- geometric multigrid ----------------------------------------------
    def _mg_setup(self, Eg):
        """Per-level (E_l, diag_l, fixed_l, dims) grids, by 2x2x2 mean
        pooling with a x2 scale per level (3-D stiffness scales linearly
        with the element size), and the Cholesky factor of the coarsest
        level's matrix, assembled by one batched product on the
        identity."""
        return self._mg_levels(Eg, 0)

    def _mg_pool(self, Eg, l0, l1):
        """(levels l0 .. l1-1, level l1's element grid) from level l0's
        element grid Eg, each next grid by 2x2x2 mean pooling, x2."""
        levels = []
        for li in range(l0, l1):
            cx, cy, cz = Eg.shape
            fixed_g = self._mg_fixed[li]
            levels.append((Eg, _diag_grid(self.KE, Eg, fixed_g,
                                          self._node_sum), fixed_g,
                           cx, cy, cz))
            if li + 1 < len(self._mg_dims):
                Eg = 2.0 * Eg.reshape(cx // 2, 2, cy // 2, 2,
                                      cz // 2, 2).mean(dim=(1, 3, 5))
        return levels, Eg

    def _mg_levels(self, Eg, l0):
        """(levels l0.., the coarsest level's Cholesky factor) from level
        l0's element grid."""
        levels, _ = self._mg_pool(Eg, l0, len(self._mg_dims))
        Eg_c, _, fixed_g, cx, cy, cz = levels[-1]
        ndc = 3 * (cx + 1) * (cy + 1) * (cz + 1)
        eye = torch.eye(ndc, dtype=Eg_c.dtype, device=Eg_c.device)
        # row i of the batched product is K e_i: transpose to columns
        Kc = _from_grid3(self._kmul_g(
            Eg_c, _to_grid3(eye, cx + 1, cy + 1, cz + 1), fixed_g,
            zero_entry=True)).T
        chol = torch.linalg.cholesky_ex(Kc).L
        return levels, chol

    def _mg_vcycle(self, levels, chol, r):
        """Symmetric V-cycle on SoA grids: weighted-Jacobi smoothing,
        trilinear transfer, dense coarse solve."""
        return self._mg_cycle(levels, chol, 0, r)

    def _mg_cycle(self, levels, chol, l, r):
        """The V-cycle from level l down, in a ``paropt.fem.mg.l<l>`` span
        (the coarsest level's solve in ``paropt.fem.mg.coarse``)."""
        nu, om = self.mg_smooth, self.mg_omega
        Eg, diag, fixed, cx, cy, cz = levels[l]
        if l == len(levels) - 1:
            with span("paropt.fem.mg.coarse"):
                y = torch.linalg.solve_triangular(
                    chol, _from_grid3(r)[:, None], upper=False)
                e = torch.linalg.solve_triangular(chol.T, y, upper=True)
                e = _to_grid3(e[:, 0], cx + 1, cy + 1, cz + 1)
                return torch.where(fixed > 0, 0.0, e)

        def kmul(v):
            return self._kmul_g(Eg, v, fixed, zero_entry=True)

        with span(f"paropt.fem.mg.l{l}"):
            e = (om / diag) * r
            for _ in range(nu - 1):
                e = e + (om / diag) * (r - kmul(e))
            rc = self._restrict(r - kmul(e))
            rc = torch.where(self._mg_fixed[l + 1] > 0, 0.0, rc)
            e = e + torch.where(fixed > 0, 0.0, self._prolong(
                self._mg_cycle(levels, chol, l + 1, rc)))
            for _ in range(nu):
                e = e + (om / diag) * (r - kmul(e))
            return e

    def _solve(self, E):
        with span("paropt.fem.solve"):
            return self._cg(E, self.f)

    def _cg(self, E, b):
        """Preconditioned CG on K(E) u = b (fixed dofs zeroed): Jacobi
        (solver='jacobi') or a multigrid V-cycle (solver='mgcg').  Flat
        [ndof] in and out; every iteration runs on SoA grids, with a fixed
        count and the breakdown guards as tensor ``where``s."""
        Eg = E.reshape(self.nex, self.ney, self.nez)
        fixed_g = self._fixed_g
        if self.solver == "mgcg" and len(self._mg_dims) > 1:
            with span("paropt.fem.mg_setup"):
                levels, chol = self._mg_setup(Eg)

            def precond(r):
                return self._mg_vcycle(levels, chol, r)
        else:
            diag_g = _diag_grid(self.KE, Eg, fixed_g, self._node_sum)

            def precond(r):
                return r / diag_g

        bg = torch.where(fixed_g > 0, 0.0, self._grid(b))
        # a guard representable in the dtype (1e-300 underflows in f32)
        tiny = torch.finfo(self._dtype).tiny
        u = torch.zeros_like(bg)
        r = bg
        p = precond(bg)
        rz = self._dot(bg, p)
        for _ in range(self.cg_iters):
            with span("paropt.fem.kmul"):
                Kp = self._kmul_g(Eg, p, fixed_g, zero_entry=False)
            pKp = self._dot(p, Kp)
            alpha = torch.where(pKp > tiny,
                                rz / torch.where(pKp > tiny, pKp, 1.0), 0.0)
            u = u + alpha * p
            r = r - alpha * Kp
            z = precond(r)
            rz_new = self._dot(r, z)
            beta = torch.where(rz > tiny,
                               rz_new / torch.where(rz > tiny, rz, 1.0), 0.0)
            p = z + beta * p
            rz = rz_new
        return _from_grid3(u)

    # -- compliance and its adjoint gradient ----------------------------
    def _simp(self, xf):
        return self.emin + xf ** self.penal * (self.e0 - self.emin)

    def _state(self, xf):
        u = self._solve(self._simp(xf))
        return self._dot(self.f, u), u

    def _element_energies(self, u):
        """u_e' KE u_e for every element, flat [ne]."""
        return self._energy_g(self._grid(u)).reshape(-1)

    def _compliance_vjp(self, xf, u, ct):
        dE = self.penal * xf ** (self.penal - 1.0) * (self.e0 - self.emin)
        return -ct * dE * self._element_energies(u)

    # -- Problem surface --------------------------------------------------
    def _design_field(self, x):
        return self._filter(x)

    def constraints(self, x):
        return (self.volume_fraction - self._mean(x)).reshape(1)

    def sparse_constraints(self, x):
        return self.region_cap - torch.mean(
            x.reshape(self.nwcon, self.region), dim=1)

    def sparse_jacobian(self, x):
        return self._jac

    def _strip_view(self, mesh):
        return _FEM3DStrip(self, mesh)

    def get_vars_and_bounds(self):
        kw = dict(dtype=self._dtype, device=self._device)
        n = self.nvars
        return (torch.full((n,), self.volume_fraction, **kw),
                torch.zeros(n, **kw), torch.ones(n, **kw))


@strip_evaluations
class DMOFEMTopology3D(_StateMemo, Problem):
    """Multi-material (DMO) 3-D voxel compliance design: per-voxel material
    weights x[e, m] with one "weights sum <= 1" constraint per voxel (the
    'blocked' sparse pattern).

        E_e = emin + Σ_m x[e,m]^p (E_m − emin)
        min  compliance(E)
        s.t. mass_fraction − Σ_{e,m} ρ_m x[e,m]/ne >= 0   (dense)
             1 − Σ_m x[e,m] >= 0                          (per voxel)
    """

    def __init__(self, nex: int = 12, ney: int = 6, nez: int = 6,
                 e_mats=(1.0, 0.55, 0.25), rho_mats=(1.0, 0.5, 0.2),
                 mass_fraction: float = 0.3, penal: float = 3.0,
                 cg_iters: int = 400, solver: str = "jacobi",
                 layout: str = "auto", dtype=None, device=None):
        dt = resolve_dtype(dtype)
        self.fem = FEMTopology3D(nex=nex, ney=ney, nez=nez,
                                 cg_iters=cg_iters, filter_on=False,
                                 solver=solver, layout=layout, dtype=dt,
                                 device=device)
        ne = self.fem.ne
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
        return self.fem._dot(self.fem.f, u), u

    def _compliance_vjp(self, x, u, ct):
        energies = self.fem._element_energies(u)               # [ne]
        xm = x.reshape(self.ne, self.nmat)
        dwdx = self.penal * xm ** (self.penal - 1.0)
        dE = dwdx * (self.e_mats - self.emin)[None, :]         # [ne, nmat]
        return (-ct * energies[:, None] * dE).reshape(-1)

    # -- Problem surface --------------------------------------------------
    def constraints(self, x):
        mass = self.fem._mean(x.reshape(self.ne, self.nmat) @ self.rho_mats)
        return (self.mass_fraction - mass).reshape(1)

    def sparse_constraints(self, x):
        return 1.0 - torch.sum(x.reshape(self.ne, self.nmat), dim=1)

    def sparse_jacobian(self, x):
        return self._jac

    def _strip_view(self, mesh):
        view = _view_of(self)
        view.fem = self.fem._strip_view(mesh)
        view.ne = view.fem.ne
        return view

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


class _FEM3DStrip(FEMTopology3D):
    """`FEMTopology3D` on this rank's x-slab of the voxel grid
    (`parallel.halo`; the 2-D `fem_topology._FEMStrip` has the scheme): m =
    nex / P element slabs and m + 1 node slabs on axis 0, halos along that
    axis only, the V-cycle on slabs down to `mg_gather_level` and whole
    below it.  Built by `FEMTopology3D._strip_view`."""

    def __init__(self, whole: FEMTopology3D, mesh):
        self.__dict__.update(_fields_of(whole))
        s = halo.Strips(mesh, whole.nex, type(whole).__name__)
        dims = whole._mg_dims
        g = mg_gather_level(dims, s.P)
        if whole.solver == "mgcg" and len(dims) > 1 and g == 0:
            raise ValueError(
                f"{type(whole).__name__} with solver='mgcg' on sharded "
                f"state needs an even number of element slabs per rank "
                f"(nex / P = {s.m}): the V-cycle restricts on the slabs")
        self._whole, self._strips, self._mg_gather = whole, s, g
        nny, nnz = whole.ney + 1, whole.nez + 1
        self.nex, self.ne = s.m, s.m * whole.ney * whole.nez
        self.ndof = 3 * (s.m + 1) * nny * nnz
        self.fixed_mask = s.node_rows(whole.fixed_mask, 3 * nny * nnz)
        self._fixed_g = _to_grid3(self.fixed_mask, s.m + 1, nny, nnz)
        self.f = s.node_rows(whole.f, 3 * nny * nnz)
        self._level_strips = [s.level(cx) for cx, _, _ in dims[:g + 1]]
        self._mg_fixed = [ls.node_rows(whole._mg_fixed[l], 1, axis=-3)
                          for l, ls in enumerate(self._level_strips)]
        self._restrict = self._restrict_slabs

    def _node_sum(self, g):
        return halo.halo_add(g, -3, self._strips)

    def _restrict_slabs(self, r):
        """`_restrict3d` on slabs: the ghost slab zeroed so each shared
        fine slab counts once, then the coarse shared slabs summed."""
        s = self._strips
        return halo.halo_add(self._whole._restrict(s.zero_ghost(r, -3)), -3,
                             s)

    def _dot(self, a, b):
        s = self._strips
        if a.dim() == 1:
            return halo.allreduce(dot(s.owned_flat(a), s.owned_flat(b)), s)
        return halo.owned_dot(a, b, -3, s)

    def _mean(self, t):
        s = self._strips
        if s.P == 1:
            return torch.mean(t)
        return halo.allreduce(torch.sum(t), s) / (t.numel() * s.P)

    def _filter(self, x):
        s = self._strips
        if not self.filter_on or s.P == 1:
            return super()._filter(x)
        xg = x.reshape(self.nex, self.ney, self.nez)
        ext = halo.wrap_rows(xg, -3, s)
        acc = xg
        cnt = torch.ones_like(xg)
        for ax in (0, 1, 2):
            for sh in (1, -1):
                # a roll by sh slabs reads slab i - sh: ext's i + 1 - sh
                acc = acc + (ext[1 - sh:1 - sh + self.nex] if ax == 0
                             else torch.roll(xg, sh, dims=ax))
                cnt = cnt + 1.0
        return (acc / cnt).reshape(-1)

    def _mg_setup(self, Eg):
        g = self._mg_gather
        levels, Eg = self._mg_pool(Eg, 0, g)
        Eg = halo.gather_rows(Eg, -3, self._level_strips[g], ghost=False)
        rest, chol = self._whole._mg_levels(Eg, g)
        return levels + rest, chol

    def _mg_cycle(self, levels, chol, l, r):
        if l < self._mg_gather:
            return super()._mg_cycle(levels, chol, l, r)
        s = self._level_strips[l]
        e = self._whole._mg_cycle(levels, chol, l,
                                  halo.gather_rows(r, -3, s))
        return s.node_rows(e, 1, axis=-3)
