"""Frequency-constrained SIMP topology optimization, 2-D and 3-D
(counterpart of paropt_tpu/models/fem_frequency.py, where the models are
documented):

    min   mass(x) = mean(xf)
    s.t.  KS_min(lam(x)) >= lam_target            (one dense constraint)
          lb <= x <= 1

with lam the N lowest natural-frequency eigenvalues of K(x) phi =
lam M(x) phi (SIMP stiffness, lumped diagonal mass), aggregated by a
Kreisselmeier–Steinhauser minimum over the gaps (lam_i - lam_t) / lam_t.

As in the JAX package: the N lowest eigenpairs are the largest of
S = M^½ K⁻¹ M^½ (lam = 1/mu, phi = M^-½ v), found by LOBPCG
(`ops.lobpcg`, the port's copy of JAX's), where S applies the FEM model's
CG to the N columns at once (``torch.func.vmap`` over the single-column
solve, the same arithmetic per column); the eigenvalue sensitivities are
analytic and element-local, dlam_i/dxf_e = phi_e' dK_e phi_e −
lam_i phi_e' dM_e phi_e, chained through the density filter by one vjp.
The host path (``eval_obj_con`` and friends) reduces the KS aggregate in
float64 numpy and caches the last two points; ``eval_full`` (the fused
eigen-TR's evaluation) reduces it in the compute dtype and can warm-start
LOBPCG from the previous basis.  LOBPCG reads its exit test on the host
once per block iteration: ``syncs`` counts those reads and
``lobpcg_iters_log`` records each eigensolve's block iterations.

On a sharded design vector the models evaluate on their x-strips
(`_strip_view`, `parallel.halo`): the FEM's strip view, LOBPCG's blocks
whole on every rank, S applied on strips and gathered once per
application.
"""

from __future__ import annotations

import functools
from typing import List

import numpy as np
import torch
import torch.nn.functional as F

from ..dtypes import resolve_device, resolve_dtype
from ..ip import HostSyncs
from ..ops.lobpcg import lobpcg_standard, lobpcg_standard_batched
from ..parallel import halo
from ..parallel.halo import strip_evaluations
from ..problem import Problem
from ..utils.spans import span
from .fem_topology import FEMTopology, _view_of
from .fem_topology3d import (_CORNERS3D, FEMTopology3D, _from_grid3, _sl,
                             _to_grid3)

__all__ = ["FrequencyTopology", "FrequencyTopology3D"]


@strip_evaluations
class _FrequencyBase(Problem):
    """The KS aggregate and its eigen model, shared by the 2-D and 3-D
    models.  Subclasses set ``fem``, ``N``, ``ks_rho``, ``rho_min``, ``lb``,
    ``lobpcg_iters``, ``_X0`` and ``_dtype``, define ``_sensitivities``,
    and call `_setup` last."""

    def _setup(self, freq_fraction: float):
        self.syncs = HostSyncs()
        self.lobpcg_iters_log: List[int] = []
        self._cache = {}
        # the frequency target: a fraction of the full-material fundamental
        # eigenvalue, so x0 = 1 is strictly feasible
        x0 = torch.ones(self.nvars, dtype=self._dtype, device=self._device)
        lam_full, _, _ = self._eig_fn(x0, None)
        self.lam_target = freq_fraction * float(lam_full[0])

    def _minv_floor(self) -> float:
        """Relative eigenvalue floor of the regularized KS-curvature
        inverse: bounds cond(M) by 1/floor so the merged compact's small
        solves stay accurate in the compute dtype (float64 1e-8, float32
        1e3·eps)."""
        return max(1e-8, 1e3 * torch.finfo(self._dtype).eps)

    def _eig_prep(self, x):
        """(xf, E, msqrt) at x: the filtered density, the SIMP moduli and
        the square root of the lumped mass."""
        xf = self.fem._filter(x)
        return xf, self.fem._simp(xf), torch.sqrt(self._mass(xf))

    def _eig_post(self, x, xf, msqrt, mu, V):
        """(lam [N] ascending, W [N, nvars] = dlam/dx) from the eigenpairs
        (mu, V) of S: the element-local sensitivities chained through the
        density filter by one vjp."""
        lam = 1.0 / mu                       # ascending: lam[0] smallest
        # phi = M^-½ v: unit v gives phi' M phi = 1
        phi = torch.where(msqrt[:, None] > 0, V / msqrt[:, None], 0.0)
        kterm, mterm = self._sensitivities(phi.T)
        fem = self.fem
        dE = fem.penal * xf ** (fem.penal - 1.0) * (fem.e0 - fem.emin)
        Wf = dE[None, :] * kterm \
            - lam[:, None] * (1.0 - self.rho_min) * mterm
        _, filt_vjp = torch.func.vjp(self.fem._filter, x)
        return lam, torch.func.vmap(lambda w: filt_vjp(w)[0])(Wf)

    def _eig_fn(self, x, V0=None):
        """(lam [N] ascending, W [N, nvars] = dlam/dx, V [ndof, N] the
        M^½-basis) at x; a cold start from the seeded block unless V0."""
        xf, E, msqrt = self._eig_prep(x)
        cg = torch.func.vmap(lambda col: self.fem._cg(E, col), in_dims=1,
                             out_dims=1)

        def S(vblock):                       # [ndof, k] -> [ndof, k]
            return self._whole_rows(
                msqrt[:, None] * cg(msqrt[:, None] * self._own_rows(vblock)))

        X = self._X0 if V0 is None else V0
        with span("paropt.eig.lobpcg"):
            mu, V, iters = lobpcg_standard(S, X, m=self.lobpcg_iters,
                                           syncs=self.syncs)
        self.lobpcg_iters_log.append(iters)
        lam, W = self._eig_post(x, xf, msqrt, mu, self._own_rows(V))
        return lam, W, V

    @staticmethod
    def _own_rows(v):
        """A whole basis block's rows this model's FEM holds (the strip
        view's: its strip's)."""
        return v

    @staticmethod
    def _whole_rows(v):
        """The whole block of which ``v`` holds this model's rows (the
        strip view gathers the strips)."""
        return v

    def _eig_fn_batched(self, xs, V0=None):
        """`_eig_fn` of kb instances: xs [kb, nvars], V0 [kb, ndof, N] or
        None (every instance from the seeded block).  The filter, SIMP,
        mass and sensitivities run under ``torch.func.vmap`` over the
        instances, S applies the fixed-count CG vmapped over instances and
        columns, and `lobpcg_standard_batched` reads the batch's exit once
        per block iteration.  ``lobpcg_iters_log`` gets a list of kb
        counts.  Returns (lam [kb, N], W [kb, N, nvars], V [kb, ndof, N])."""
        xf, E, msqrt = torch.func.vmap(self._eig_prep)(xs)
        cg = torch.func.vmap(
            torch.func.vmap(self.fem._cg, in_dims=(None, 1), out_dims=1))

        def S(vblock):                   # [kb, ndof, k] -> [kb, ndof, k]
            return msqrt[..., None] * cg(E, msqrt[..., None] * vblock)

        X = self._X0 if V0 is None else V0
        with span("paropt.eig.lobpcg"):
            mu, V, iters = lobpcg_standard_batched(
                S, X, m=self.lobpcg_iters, syncs=self.syncs)
        self.lobpcg_iters_log.append(iters)
        lam, W = torch.func.vmap(self._eig_post)(xs, xf, msqrt, mu, V)
        return lam, W, V

    def _eval(self, x):
        """The cached eigensolve at x with the KS reduction in float64
        numpy (the host path)."""
        x = torch.as_tensor(x, dtype=self._dtype, device=self._device)
        key = self.syncs.array(x).tobytes()
        hit = self._cache.get(key)
        if hit is not None:
            return hit
        lam, W, _ = self._eig_fn(x, None)
        lam64 = self.syncs.array(lam).astype(np.float64)
        W64 = self.syncs.array(W).astype(np.float64)
        g = (lam64 - self.lam_target) / self.lam_target
        gmin = g.min()
        eta = np.exp(-self.ks_rho * (g - gmin))
        beta = eta.sum()
        eta /= beta
        ks = gmin - np.log(beta) / self.ks_rho
        dks = (eta @ W64) / self.lam_target
        out = {"lam": lam64, "W": W64, "ks": ks, "dks": dks, "eta": eta}
        # keep only the two live points (current and trial)
        if len(self._cache) >= 2:
            self._cache.pop(next(iter(self._cache)))
        self._cache[key] = out
        return out

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=self._dtype, device=self._device)

    # -- the Problem surface (the constraint is not differentiable through
    #    the eigensolve: its gradient is the analytic one) ----------------
    def objective(self, x):
        return self.fem._mean(self.fem._filter(x))

    def eval_obj_con(self, x):
        ev = self._eval(x)
        return self.objective(x), self._tensor([ev["ks"]])

    def eval_obj_con_gradient(self, x):
        ev = self._eval(x)
        g = torch.func.grad(self.objective)(self._tensor(x))
        return g, self._tensor(ev["dks"])[None, :]

    def get_vars_and_bounds(self):
        kw = dict(dtype=self._dtype, device=self._device)
        n = self.nvars
        return (torch.ones(n, **kw), torch.full((n,), self.lb, **kw),
                torch.ones(n, **kw))

    def update_eigen_model(self, x, eigh) -> None:
        """Refresh the low-rank KS model at an accepted point: hvecs = W,
        M = rho/lam_t² (eta etaᵀ − diag eta) (rank N−1, NSD), and Minv the
        inverse with M's eigenvalues clamped at −floor·scale, which keeps
        it NSD and bounded (`_minv_floor`; paropt_tpu's docstring has the
        failures a raw pinv or a fixed floor caused)."""
        ev = self._eval(x)
        eta = ev["eta"]
        scale = self.ks_rho / self.lam_target ** 2
        M = scale * (np.outer(eta, eta) - np.diag(eta))
        e, Q = np.linalg.eigh(0.5 * (M + M.T))
        e = np.minimum(e, -self._minv_floor() * scale)
        Minv = (Q / e) @ Q.T
        eigh.set_approximation(M=self._tensor(M), Minv=self._tensor(Minv),
                               hvecs=self._tensor(ev["W"]))

    def eval_full(self, x, V0=None):
        """The fused eigen-TR's evaluation: ONE eigensolve gives the
        objective, the KS constraint, both gradients and the refreshed
        model (M, Minv, hvecs), with the KS reduction in the compute dtype.
        ``V0`` warm-starts LOBPCG from a previous basis (same iteration
        budget: the residual exit makes a converged warm basis cheap).
        Returns (f, c [1], g, A [1, n], M, Minv, h, V)."""
        x = torch.as_tensor(x, dtype=self._dtype, device=self._device)
        lam, W, V = self._eig_fn(x, V0)
        return self._ks_model(x, lam, W) + (V,)

    def eval_full_batched(self, xs, V0=None):
        """`eval_full` of kb instances (xs [kb, nvars], V0 [kb, ndof, N] or
        None) through one batched eigensolve (`_eig_fn_batched`); every
        output carries the instance axis first."""
        xs = torch.as_tensor(xs, dtype=self._dtype, device=self._device)
        lam, W, V = self._eig_fn_batched(xs, V0)
        return torch.func.vmap(self._ks_model)(xs, lam, W) + (V,)

    def _ks_model(self, x, lam, W):
        """(f, c [1], g, A [1, n], M, Minv, h) from the eigenvalues and
        their sensitivities at x, in the compute dtype."""
        g = (lam - self.lam_target) / self.lam_target
        gmin = torch.min(g)
        eta = torch.exp(-self.ks_rho * (g - gmin))
        beta = torch.sum(eta)
        eta = eta / beta
        ks = gmin - torch.log(beta) / self.ks_rho
        dks = (eta @ W) / self.lam_target
        fobj = self.objective(x)
        gobj = torch.func.grad(self.objective)(x)
        scale = self.ks_rho / self.lam_target ** 2
        M = scale * (torch.outer(eta, eta) - torch.diag(eta))
        e, Q = torch.linalg.eigh(0.5 * (M + M.T))
        e = torch.clamp(e, max=-self._minv_floor() * scale)
        Minv = (Q / e) @ Q.T
        return (fobj, ks.reshape(1), gobj, dks[None, :], M, Minv, W)

    def build_fused_tr(self, options=None, eig_row_model="linear"):
        """The fused eigen TR (`eig_fused.FusedEigenTR`) with the QN seeded
        at b0 = 1/nvars (see `build_tr_subproblem`)."""
        from ..eig_fused import FusedEigenTR
        return FusedEigenTR(self, options, index=0,
                            qn_b0=1.0 / self.nvars,
                            eig_row_model=eig_row_model)

    def build_tr_subproblem(self, msub: int = 10):
        """The eigenvalue TR subproblem (`eigenvalue_opt.py:281-306`) with
        the model refreshed at x0.  The QN starts from b0 = 1/nvars: the
        mass objective is linear with gradient 1/nvars per element, so
        while the constraint is slack every curvature update is skipped
        and b0 = 1 would take gradient-sized steps."""
        from ..eig import CompactEigenApprox, EigenQuasiNewton, \
            EigenSubproblem
        from ..ops import qn as qnmod

        eigh = CompactEigenApprox(nvars=self.nvars, N=self.N,
                                  dtype=self._dtype, device=self._device)
        qn0 = qnmod.qn_init(msub, self.nvars, dtype=self._dtype,
                            b0=1.0 / self.nvars, device=self._device)
        eqn = EigenQuasiNewton(qn0, eigh, index=0)
        sub = EigenSubproblem(self, eqn)
        sub.set_eigen_model_update(self.update_eigen_model)
        x0, _, _ = self.get_vars_and_bounds()
        _, c0 = self.eval_obj_con(x0)
        _, A0 = self.eval_obj_con_gradient(x0)
        eigh.set_approximation(c0=c0[0], g0=A0[0])
        self.update_eigen_model(x0, eigh)
        return sub, eigh

    def _strip_view(self, mesh):
        """The model on this rank's x-strip (`parallel.halo`): the FEM's
        strip view, and the eigensolve's operator S on strips
        (`_own_rows`, `_whole_rows`).  LOBPCG's blocks stay whole on every
        rank: S takes each block's strip rows (no exchange: the block is
        replicated), runs the strips' CG on them and gathers the result
        whole, once per application; every rank then runs the same
        Rayleigh-Ritz."""
        view = _view_of(self)
        view.fem = self.fem._strip_view(mesh)
        view._cache = {}
        s = view.fem._strips
        row = view.fem.ndof // (s.m + 1)
        view._own_rows = functools.partial(s.node_rows, row=row)
        view._whole_rows = lambda v: halo.gather_rows(
            v.reshape(s.m + 1, row, -1), -3, s).reshape(-1, v.shape[-1])
        return view

    def frequencies(self, x):
        """The N lowest natural frequencies sqrt(lam) at x."""
        return np.sqrt(np.maximum(self._eval(x)["lam"], 0.0))


def _start_block(fem, N, seed, kw):
    """The seeded LOBPCG start block [ndof, N], zero on fixed dofs."""
    rng = np.random.default_rng(seed)
    X0 = rng.standard_normal((fem.ndof, N))
    X0[fem.fixed_mask.cpu().numpy() > 0, :] = 0.0
    return torch.as_tensor(X0, **kw)


class FrequencyTopology(_FrequencyBase):
    """The 2-D frequency-constrained cantilever on `FEMTopology`'s mesh,
    element matrices and CG.  ``device`` holds every array (the card unless
    the caller names another); the constructor turns TF32 off."""

    def __init__(self, nex: int = 32, ney: int = 16, N: int = 6,
                 ks_rho: float = 30.0, freq_fraction: float = 0.5,
                 rho_min: float = 0.025, lb: float = 0.05,
                 cg_iters: int = 200, lobpcg_iters: int = 60,
                 filter_radius: int = 1, solver: str = "jacobi",
                 dtype=None, seed: int = 0, device=None):
        super().__init__(nvars=nex * ney, ncon=1)
        self._dtype = resolve_dtype(dtype)
        self._device = resolve_device(device)
        self.fem = FEMTopology(nex=nex, ney=ney, cg_iters=cg_iters,
                               filter_radius=filter_radius, solver=solver,
                               dtype=self._dtype, device=self._device)
        self.N = N
        self.ks_rho = float(ks_rho)
        self.rho_min = float(rho_min)
        self.lb = float(lb)
        self.lobpcg_iters = int(lobpcg_iters)
        self._X0 = _start_block(self.fem, N, seed,
                                dict(dtype=self._dtype, device=self._device))
        self._setup(freq_fraction)

    def _mass_diag(self, xf):
        """Lumped mass: element mass rho_e (unit area) split over its 4
        nodes, on both dofs of each node."""
        rho = self.rho_min + xf * (1.0 - self.rho_min)
        m = self.fem._scatter_elem(
            torch.broadcast_to((rho / 4.0)[:, None], (rho.shape[0], 8)))
        return torch.where(self.fem.fixed_mask > 0, 0.0, m)

    _mass = _mass_diag

    def _sensitivities(self, modes):
        """Per mode and element: phi_e' k0 phi_e and sum phi_e² / 4, each
        [N, ne], from modes [N, ndof]."""
        fem = self.fem
        phie = fem._gather_elem(modes)                 # [N, ne, 8]
        kterm = torch.sum((phie @ fem.KE) * phie, dim=-1)
        mterm = torch.sum(phie * phie, dim=-1) / 4.0
        return kterm, mterm


class FrequencyTopology3D(_FrequencyBase):
    """The 3-D frequency-constrained voxel cantilever on `FEMTopology3D`:
    the CG solves, phi' dK phi (``_energy_g``) and the mass terms (corner
    slices) all on SoA component grids, with no [ne, 24] tensor in the
    eigensolve.  ``device`` as in `FrequencyTopology`."""

    def __init__(self, nex: int = 16, ney: int = 8, nez: int = 8,
                 N: int = 6, ks_rho: float = 30.0,
                 freq_fraction: float = 0.5, rho_min: float = 0.025,
                 lb: float = 0.05, cg_iters: int = 30,
                 lobpcg_iters: int = 60, solver: str = "mgcg",
                 layout: str = "auto", dtype=None, seed: int = 0,
                 device=None):
        super().__init__(nvars=nex * ney * nez, ncon=1)
        self._dtype = resolve_dtype(dtype)
        self._device = resolve_device(device)
        self.fem = FEMTopology3D(nex=nex, ney=ney, nez=nez,
                                 cg_iters=cg_iters, solver=solver,
                                 layout=layout, dtype=self._dtype,
                                 device=self._device)
        self.N = N
        self.ks_rho = float(ks_rho)
        self.rho_min = float(rho_min)
        self.lb = float(lb)
        self.lobpcg_iters = int(lobpcg_iters)
        self._X0 = _start_block(self.fem, N, seed,
                                dict(dtype=self._dtype, device=self._device))
        self._setup(freq_fraction)

    def _mass_grids(self, xf):
        """(node mass as a [3, nnx, nny, nnz] grid, flat [ndof]): element
        mass rho_e split over its 8 nodes, on all 3 dofs of each node."""
        fem = self.fem
        rho = self.rho_min + xf * (1.0 - self.rho_min)
        rg = rho.reshape(fem.nex, fem.ney, fem.nez) / 8.0
        m = None
        for a, b, c in _CORNERS3D:
            t = F.pad(rg, (c, 1 - c, b, 1 - b, a, 1 - a))
            m = t if m is None else m + t
        m = fem._node_sum(m)
        mg = torch.where(fem._fixed_g > 0, 0.0,
                         torch.broadcast_to(m[None], fem._fixed_g.shape))
        return mg, _from_grid3(mg)

    def _mass(self, xf):
        return self._mass_grids(xf)[1]

    def _sensitivities(self, modes):
        """Per mode and element, grid form: phi_e' k0 phi_e and
        sum_corners sum_c phi_c² / 8, each [N, ne], from modes
        [N, ndof]."""
        fem = self.fem
        pg = _to_grid3(modes, fem.nex + 1, fem.ney + 1, fem.nez + 1)
        kterm = torch.func.vmap(fem._energy_g)(pg).reshape(
            modes.shape[0], -1)
        s = torch.sum(pg * pg, dim=-4)               # [N, nnx, nny, nnz]
        mterm = None
        for a, b, c in _CORNERS3D:
            t = s[..., _sl(a), _sl(b), _sl(c)]
            mterm = t if mterm is None else mterm + t
        return kterm, mterm.reshape(modes.shape[0], -1) / 8.0
