"""KKT system assembly and solution for the interior-point method
(counterpart of paropt_tpu/ops/kkt.py; the algebra is documented there).

Newton elimination of the elastic double-slack formulation reduces to

    [H    -A'   -Aw'] [px ]   [bx ]         H  = B + Zl/(X-Lb) + Zu/(Ub-X)
    [A     Γ     0  ] [pz ] = [bc ]         Γ  = S/Zs + T/Zt        (diag)
    [Aw    0     C0 ] [pzw]   [bcw]         C0 = Sw/Zsw + Tw/Ztw    (diag)

solved through the block-diagonal Cw = C0 + Aw·D⁻¹·Aw', an ncon×ncon Schur
complement (Gmat) and a Sherman-Morrison-Woodbury correction (Ce) for the
compact quasi-Newton term B = b0·I - Z'M⁻¹Z.

Routing on the (blocked_t, nwblock == 1) layout of the main path:

- `quasi_def_solve` goes through `kernels.quasi_def_apply` at every batch
  size;
- `setup_kkt_factor` goes through `_setup_factor_fused`, and so through
  `kernels.phi_gram`, when a compact QN term in the compute dtype is
  present: one sweep reads the [2m+ncon, n] stack [Z; A] once.

On a CUDA tensor the kernels launch; on a CPU tensor their plain versions run.
On state sharded over a device mesh each rank launches them on its shard
(`kernels`' DTensor rules); the mesh size must divide k and nwcon.

The general-CSR path factors Cw, which is not block diagonal there, on the
host (`HostCSRFactor` over `sparse_native.CSRQuasiDefMat`) and bypasses both
kernels; a problem without a structured Jacobian passes its products as
``ProblemData.Aw_callbacks``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from ..dtypes import resolve_device, resolve_dtype
from ..tree import pytree, static_field, tmap
from . import kernels
from .veclib import matmul

__all__ = ["IPVars", "ProblemData", "KKTFactor", "HostCSRFactor",
           "zero_vars",
           "detect_aw_layout", "kkt_residual", "setup_kkt_factor",
           "quasi_def_solve", "solve_kkt", "apply_kkt_matrix",
           "reduced_rhs", "recover_full_step", "max_step_lengths",
           "average_complementarity"]


def detect_aw_layout(cols, n) -> str:
    """Classify the sparse-Jacobian pattern: 'blocked' (cols ==
    arange(n).reshape(nwcon, k)), 'blocked_t' (cols[i, j] == i + j·nwcon,
    the large axis minor) or 'gather' (anything else)."""
    if cols is None:
        return "gather"
    c = np.asarray(cols)
    if c.size != n:
        return "gather"
    nwcon, k = c.shape
    if np.array_equal(c.reshape(-1), np.arange(n)):
        return "blocked"
    want = np.arange(nwcon)[:, None] + np.arange(k)[None, :] * nwcon
    if np.array_equal(c, want):
        return "blocked_t"
    return "gather"


@pytree
@dataclasses.dataclass(frozen=True)
class IPVars:
    """Full primal-dual state; also used for steps and residuals."""
    x: torch.Tensor    # [n] design
    zl: torch.Tensor   # [n] lower-bound multipliers
    zu: torch.Tensor   # [n] upper-bound multipliers
    s: torch.Tensor    # [ncon] positive elastic slack
    t: torch.Tensor    # [ncon] negative elastic slack
    z: torch.Tensor    # [ncon] dense-constraint multipliers
    zs: torch.Tensor   # [ncon]
    zt: torch.Tensor   # [ncon]
    sw: torch.Tensor   # [nwcon]
    tw: torch.Tensor   # [nwcon]
    zw: torch.Tensor   # [nwcon]
    zsw: torch.Tensor  # [nwcon]
    ztw: torch.Tensor  # [nwcon]

    def axpy(self, alpha_x, alpha_z, p: "IPVars") -> "IPVars":
        """Primal fields step by alpha_x, dual fields by alpha_z."""
        return IPVars(
            x=self.x + alpha_x * p.x,
            zl=self.zl + alpha_z * p.zl,
            zu=self.zu + alpha_z * p.zu,
            s=self.s + alpha_x * p.s,
            t=self.t + alpha_x * p.t,
            z=self.z + alpha_z * p.z,
            zs=self.zs + alpha_z * p.zs,
            zt=self.zt + alpha_z * p.zt,
            sw=self.sw + alpha_x * p.sw,
            tw=self.tw + alpha_x * p.tw,
            zw=self.zw + alpha_z * p.zw,
            zsw=self.zsw + alpha_z * p.zsw,
            ztw=self.ztw + alpha_z * p.ztw)

    def scaled(self, alpha_x, alpha_z) -> "IPVars":
        """The step scaled by alpha_x (primal) and alpha_z (dual)."""
        return IPVars(
            x=alpha_x * self.x, zl=alpha_z * self.zl, zu=alpha_z * self.zu,
            s=alpha_x * self.s, t=alpha_x * self.t, z=alpha_z * self.z,
            zs=alpha_z * self.zs, zt=alpha_z * self.zt,
            sw=alpha_x * self.sw, tw=alpha_x * self.tw,
            zw=alpha_z * self.zw, zsw=alpha_z * self.zsw,
            ztw=alpha_z * self.ztw)


def zero_vars(n: int, ncon: int, nwcon: int, dtype=None,
              device=None) -> IPVars:
    kw = dict(dtype=resolve_dtype(dtype), device=resolve_device(device))
    zn = torch.zeros(n, **kw)
    zc = torch.zeros(ncon, **kw)
    zw = torch.zeros(nwcon, **kw)
    return IPVars(x=zn, zl=zn, zu=zn, s=zc, t=zc, z=zc, zs=zc, zt=zc,
                  sw=zw, tw=zw, zw=zw, zsw=zw, ztw=zw)


@pytree
@dataclasses.dataclass(frozen=True)
class ProblemData:
    """Problem quantities at the current point.

    ``Aw_vals_t`` is the [k, nwcon] transpose of ``Aw_vals``, stored
    contiguous once for the blocked_t layout (the kernels read it every
    solve); it is filled in at construction when not given.
    ``Aw_callbacks``, a (matvec, rmatvec, inner_blocks) triple of functions,
    stands in for the structured Jacobian of a problem that has none."""
    g: torch.Tensor                 # [n] objective gradient
    A: torch.Tensor                 # [ncon, n] dense constraint Jacobian
    c: torch.Tensor                 # [ncon]
    cw: torch.Tensor                # [nwcon]
    lb: torch.Tensor                # [n]
    ub: torch.Tensor                # [n]
    lb_mask: torch.Tensor           # [n] 1.0 where the bound is finite
    ub_mask: torch.Tensor           # [n]
    gamma_s: torch.Tensor           # [ncon] elastic penalties
    gamma_t: torch.Tensor           # [ncon]
    gamma_sw: torch.Tensor          # [nwcon]
    gamma_tw: torch.Tensor          # [nwcon]
    Aw_cols: Optional[torch.Tensor] = None    # [nwcon, k] int64
    Aw_vals: Optional[torch.Tensor] = None    # [nwcon, k]
    Aw_vals_t: Optional[torch.Tensor] = None  # [k, nwcon] (blocked_t)
    nwblock: int = static_field(1)
    Aw_layout: str = static_field("gather")
    Aw_callbacks: Any = static_field(None)

    def __post_init__(self):
        if (self.Aw_layout == "blocked_t" and self.Aw_vals_t is None
                and isinstance(self.Aw_vals, torch.Tensor)):
            object.__setattr__(self, "Aw_vals_t",
                               self.Aw_vals.T.contiguous())

    @property
    def n(self):
        return self.g.shape[0]

    @property
    def ncon(self):
        return self.c.shape[0]

    @property
    def nwcon(self):
        return self.cw.shape[0]

    def Aw_matvec(self, px):
        """Aw @ px for px [..., n] -> [..., nwcon]."""
        if self.Aw_callbacks is not None:
            return self.Aw_callbacks[0](px)
        nwcon, k = self.Aw_cols.shape
        if self.Aw_layout == "blocked_t":
            shaped = px.reshape(px.shape[:-1] + (k, nwcon))
            return torch.sum(self.Aw_vals_t * shaped, dim=-2)
        if self.Aw_layout == "blocked":
            shaped = px.reshape(px.shape[:-1] + (nwcon, k))
            return torch.sum(self.Aw_vals * shaped, dim=-1)
        gathered = px[..., self.Aw_cols]                # [..., nwcon, k]
        return torch.sum(self.Aw_vals * gathered, dim=-1)

    def Aw_rmatvec(self, pzw):
        """Aw' @ pzw for pzw [..., nwcon] -> [..., n]."""
        if self.Aw_callbacks is not None:
            return self.Aw_callbacks[1](pzw)
        if self.Aw_layout == "blocked_t":
            contrib = self.Aw_vals_t * pzw[..., None, :]  # [..., k, nwcon]
            return contrib.reshape(contrib.shape[:-2] + (self.n,))
        contrib = self.Aw_vals * pzw[..., :, None]        # [..., nwcon, k]
        if self.Aw_layout == "blocked":
            return contrib.reshape(contrib.shape[:-2] + (self.n,))
        flat = contrib.reshape(contrib.shape[:-2] + (-1,))
        out = torch.zeros(contrib.shape[:-2] + (self.n,), dtype=flat.dtype,
                          device=flat.device)
        return out.index_add(-1, self.Aw_cols.reshape(-1), flat)

    def Aw_inner_blocks(self, dvec):
        """Blocks of Aw @ diag(dvec) @ Aw' -> [nblocks, nwblock, nwblock]."""
        nb = self.nwblock
        if self.Aw_callbacks is not None:
            return self.Aw_callbacks[2](dvec)
        nwcon, k = self.Aw_cols.shape
        if self.Aw_layout == "blocked_t" and nb == 1:
            dv = dvec.reshape(k, nwcon)
            return torch.sum(self.Aw_vals_t ** 2 * dv, dim=0).reshape(
                -1, 1, 1)
        if self.Aw_layout == "blocked_t":
            dw = dvec.reshape(k, nwcon).T
        elif self.Aw_layout == "blocked":
            dw = dvec.reshape(nwcon, k)
        else:
            dw = dvec[self.Aw_cols]
        if nb == 1:
            return torch.sum(self.Aw_vals ** 2 * dw, dim=1).reshape(-1, 1, 1)
        nblocks = nwcon // nb
        colsb = self.Aw_cols.reshape(nblocks, nb, k)
        valsb = self.Aw_vals.reshape(nblocks, nb, k)
        db = dw.reshape(nblocks, nb, k)
        eq = colsb[:, :, None, :, None] == colsb[:, None, :, None, :]
        prod = (valsb * db)[:, :, None, :, None] * valsb[:, None, :, None, :]
        return torch.sum(torch.where(eq, prod, 0.0), dim=(3, 4))


# ---------------------------------------------------------------------------
# residuals
# ---------------------------------------------------------------------------


def kkt_residual(v: IPVars, d: ProblemData, mu,
                 rel_bound_barrier: float = 1.0) -> IPVars:
    """Perturbed KKT residuals in an IPVars (field mapping: .x=rx .zl=rzl
    .zu=rzu .s=rs .t=rt .z=rc .zs=rzs .zt=rzt .sw=rsw .tw=rtw .zw=rcw
    .zsw=rzsw .ztw=rztw)."""
    mu_b = rel_bound_barrier * mu
    rx = d.g - d.A.T @ v.z - v.zl + v.zu
    if d.nwcon > 0:
        rx = rx - d.Aw_rmatvec(v.zw)
    rzl = torch.where(d.lb_mask > 0, (v.x - d.lb) * v.zl - mu_b, 0.0)
    rzu = torch.where(d.ub_mask > 0, (d.ub - v.x) * v.zu - mu_b, 0.0)
    return IPVars(
        x=rx, zl=rzl, zu=rzu,
        s=d.gamma_s + v.z - v.zs, t=d.gamma_t - v.z - v.zt,
        z=d.c - v.s + v.t, zs=v.s * v.zs - mu, zt=v.t * v.zt - mu,
        sw=d.gamma_sw + v.zw - v.zsw, tw=d.gamma_tw - v.zw - v.ztw,
        zw=d.cw - v.sw + v.tw, zsw=v.sw * v.zsw - mu, ztw=v.tw * v.ztw - mu)


# ---------------------------------------------------------------------------
# diagonal KKT system + quasi-definite factorization
# ---------------------------------------------------------------------------


@pytree
@dataclasses.dataclass(frozen=True)
class KKTFactor:
    """Factored per-iteration KKT data."""
    Dinv: torch.Tensor                 # [n] inverse of diagonal H0
    Gamma: Optional[torch.Tensor]      # [ncon]
    C0: Optional[torch.Tensor]         # [nwcon]
    Cw_chol: Optional[torch.Tensor]    # [nblocks, nwblock, nwblock]
    Xa: Optional[torch.Tensor]         # [ncon, n] quasi-def solves of A
    Wa: Optional[torch.Tensor]         # [ncon, nwcon]
    G_lu: Any                          # Gmat⁻¹ (ncon <= 2) or (LU, pivots)
    Zqn: Optional[torch.Tensor]        # [K, n]
    Phi_x: Optional[torch.Tensor]      # [K, n]
    Phi_z: Optional[torch.Tensor]      # [K, ncon]
    Phi_w: Optional[torch.Tensor]      # [K, nwcon]
    Ce_inv: Optional[torch.Tensor]     # explicit inverse of Ce (K x K)
    csr_solver: Any = static_field(None)  # HostCSRFactor (general CSR)


class HostCSRFactor:
    """The device side of the host sparse factor of the general-CSR path.

    ``mat`` (a `sparse_native.CSRQuasiDefMat`) factors and solves on the
    host in float64; ``syncs`` (a `HostSyncs`) counts each read of a device
    tensor to the host and the bytes moved each way.  `factor` reads Dinv
    and C0 in one transfer each; `solve` reads its right-hand sides in one
    transfer and returns the float64 result in their dtype on their device.
    (The JAX package keeps float64 there, and a float32 solve then turns
    float64 after its first step; torch does not promote a matrix product
    of mixed dtypes, so the port keeps the solve's dtype.)"""

    def __init__(self, mat, syncs):
        self.mat = mat
        self.syncs = syncs

    def set_values(self, data) -> None:
        self.mat.set_values(data)

    def get_factor_info(self) -> str:
        return self.mat.get_factor_info()

    def factor(self, Dinv: torch.Tensor, C0: torch.Tensor) -> None:
        self.mat.factor(self.syncs.array(Dinv), self.syncs.array(C0))

    def solve(self, rw: torch.Tensor) -> torch.Tensor:
        """Cw⁻¹ rw for rw [nwcon] or [K, nwcon]."""
        host = self.syncs.array(rw)
        if host.ndim == 1:
            y = self.mat.solve(host)
        else:
            y = self.mat.solve(np.asfortranarray(host.T)).T
        return self.syncs.upload(y, rw.device).to(rw.dtype)


def _bound_quotients(v: IPVars, d: ProblemData):
    ql = torch.where(d.lb_mask > 0, v.zl / (v.x - d.lb), 0.0)
    qu = torch.where(d.ub_mask > 0, v.zu / (d.ub - v.x), 0.0)
    return ql, qu


def _chol_solve_blocks(chol, b):
    """Batched lower-Cholesky solve: chol [nb, w, w], b [..., nwcon]."""
    nb, w, _ = chol.shape
    if w == 1:
        # nwblock == 1: Cw is diagonal, chol holds its sqrt
        return b / (chol[:, 0, 0] ** 2)
    bb = b.reshape(b.shape[:-1] + (nb, w, 1))
    cb = chol.expand(bb.shape[:-2] + (w, w))
    y = torch.linalg.solve_triangular(cb, bb, upper=False)
    out = torch.linalg.solve_triangular(cb.transpose(-1, -2), y, upper=True)
    return out[..., 0].reshape(b.shape)


def quasi_def_solve(f: KKTFactor, d: ProblemData, bx, bw):
    """Solve [[D, -Aw'], [Aw, C0]] [yx; yw] = [bx; bw] via the block-diagonal
    Schur complement Cw = C0 + Aw·D⁻¹·Aw'.  Batched over leading dims of
    bx [..., n] / bw [..., nwcon].  With a `csr_solver` installed (the
    general-CSR path), Cw is a general sparse matrix factored on the host."""
    if d.nwcon == 0:
        return f.Dinv * bx, bw
    if (d.Aw_layout == "blocked_t" and d.nwblock == 1
            and f.csr_solver is None):
        dt = f.Dinv.dtype
        k, nwcon = d.Aw_vals_t.shape
        bx3 = bx.to(dt).reshape(-1, k, nwcon).contiguous()
        bw2 = bw.to(dt).reshape(-1, nwcon).contiguous()
        cwinv = 1.0 / (f.Cw_chol[:, 0, 0] ** 2)   # chol holds sqrt(Cw)
        yx3, yw2 = kernels.quasi_def_apply(
            f.Dinv.reshape(k, nwcon), cwinv, d.Aw_vals_t, bx3, bw2)
        return yx3.reshape(bx.shape), yw2.reshape(bw.shape)
    rw = bw - d.Aw_matvec(f.Dinv * bx)
    if f.csr_solver is not None:
        yw = f.csr_solver.solve(rw)
    else:
        yw = _chol_solve_blocks(f.Cw_chol, rw)
    yx = f.Dinv * (bx + d.Aw_rmatvec(yw))
    return yx, yw


def _g_factor(Gmat: torch.Tensor, ncon: int):
    """Closed-form Gmat⁻¹ for ncon <= 2, else an LU factorization."""
    if ncon == 1:
        return 1.0 / Gmat
    if ncon == 2:
        det = Gmat[0, 0] * Gmat[1, 1] - Gmat[0, 1] * Gmat[1, 0]
        adj = torch.stack([torch.stack([Gmat[1, 1], -Gmat[0, 1]]),
                           torch.stack([-Gmat[1, 0], Gmat[0, 0]])])
        return adj / det
    LU, piv, _ = torch.linalg.lu_factor_ex(Gmat)
    return LU, piv


def _g_solve_rows(G_lu, rhs: torch.Tensor, ncon: int) -> torch.Tensor:
    """Gmat⁻¹ applied to each row of rhs [K, ncon] (or to rhs [ncon])."""
    if ncon <= 2:
        return rhs @ G_lu.T
    LU, piv = G_lu
    cols = rhs.T if rhs.dim() > 1 else rhs[:, None]
    out = torch.linalg.lu_solve(LU, piv, cols)
    return out.T if rhs.dim() > 1 else out[:, 0]


def setup_kkt_factor(v: IPVars, d: ProblemData, qn_compact=None,
                     qn_sigma: float = 0.0, csr_mat=None) -> KKTFactor:
    """Build all per-iteration factorizations.  ``qn_compact``: (b0, Z, M)
    from `qn_compact()`, (diag, None, None) for a diagonal Hessian, or None
    for B = I.  ``csr_mat``: the `HostCSRFactor` of the general-CSR path,
    factored here with ``.factor(Dinv, C0)``."""
    dtype = v.x.dtype
    dev = v.x.device
    ql, qu = _bound_quotients(v, d)
    if qn_compact is None:
        b0_diag = torch.ones((), dtype=dtype, device=dev)
        Zqn = Mqn = None
    else:
        b0_diag, Zqn, Mqn = qn_compact
    Dinv = 1.0 / (b0_diag + qn_sigma + ql + qu)
    ncon = d.ncon
    zeros = lambda *shape: torch.zeros(shape, dtype=dtype, device=dev)
    Gamma = v.s / v.zs + v.t / v.zt if ncon > 0 else zeros(0)

    if d.nwcon > 0 and csr_mat is not None:
        C0 = v.sw / v.zsw + v.tw / v.ztw
        csr_mat.factor(Dinv, C0)
        Cw_chol = None
    elif d.nwcon > 0:
        C0 = v.sw / v.zsw + v.tw / v.ztw
        nb = d.nwblock
        eye = torch.eye(nb, dtype=dtype, device=dev)
        Cw = d.Aw_inner_blocks(Dinv) + C0.reshape(-1, nb)[:, :, None] * eye
        # scalar blocks: the "Cholesky" is an elementwise sqrt
        Cw_chol = (torch.sqrt(Cw) if nb == 1
                   else torch.linalg.cholesky_ex(Cw).L)
    else:
        C0 = zeros(0)
        Cw_chol = None

    if (d.nwcon > 0 and d.Aw_layout == "blocked_t" and d.nwblock == 1
            and csr_mat is None and Zqn is not None and Zqn.shape[0] > 0
            and Zqn.dtype == dtype):
        return _setup_factor_fused(v, d, Dinv, Gamma, C0, Cw_chol, Zqn, Mqn)

    f0 = KKTFactor(Dinv=Dinv, Gamma=Gamma, C0=C0, Cw_chol=Cw_chol,
                   Xa=zeros(ncon, d.n), Wa=None, G_lu=None, Zqn=None,
                   Phi_x=None, Phi_z=None, Phi_w=None, Ce_inv=None,
                   csr_solver=csr_mat)
    if ncon > 0:
        Xa, Wa = quasi_def_solve(f0, d, d.A, zeros(ncon, d.nwcon))
        Gmat = torch.diag(Gamma) + d.A @ Xa.T
        G_lu = _g_factor(Gmat, ncon)
    else:
        Xa, Wa, G_lu = zeros(0, d.n), zeros(0, d.nwcon), None
    f1 = dataclasses.replace(f0, Xa=Xa, Wa=Wa, G_lu=G_lu)

    # SMW correction for the compact QN term:
    # K⁻¹ = K0⁻¹ + K0⁻¹ Ẑ Ce⁻¹ Ẑ' K0⁻¹,  Ce = M - Z K0x⁻¹ Z'
    if Zqn is not None and Zqn.shape[0] > 0:
        K = Zqn.shape[0]
        Phi_x, Phi_z, Phi_w = _solve_diag3(f1, d, Zqn, zeros(K, ncon),
                                           zeros(K, d.nwcon))
        Ce = Mqn - matmul(Zqn, Phi_x.T)
        Ce_inv = torch.linalg.inv_ex(Ce).inverse
        if Zqn.dtype != dtype:
            # narrow QN storage: the Phi stacks take Z's dtype too
            Phi_x = Phi_x.to(Zqn.dtype)
            Phi_z = Phi_z.to(Zqn.dtype)
            Phi_w = Phi_w.to(Zqn.dtype)
        return dataclasses.replace(f1, Zqn=Zqn, Phi_x=Phi_x, Phi_z=Phi_z,
                                   Phi_w=Phi_w, Ce_inv=Ce_inv)
    return f1


def _setup_factor_fused(v: IPVars, d: ProblemData, Dinv, Gamma, C0,
                        Cw_chol, Zqn, Mqn) -> KKTFactor:
    """Factor setup through `kernels.phi_gram`: one sweep solves the
    quasi-definite system for the stack [Z_qn; A] and forms
    gram[a, b] = stack_a · yx_b, which holds every small product the Schur
    complement, the SMW right-hand sides and Ce need."""
    dtype = v.x.dtype
    ncon = d.ncon
    K = Zqn.shape[0]
    B = K + ncon
    k, nwcon = d.Aw_vals_t.shape
    # the stack [Z_qn; A] is read as its two row blocks, with bw = 0
    yx3, yw2, gram = kernels.phi_gram(
        Dinv.reshape(k, nwcon), 1.0 / (Cw_chol[:, 0, 0] ** 2), d.Aw_vals_t,
        Zqn.contiguous().reshape(K, k, nwcon), None,
        d.A.contiguous().reshape(ncon, k, nwcon) if ncon else None)
    yx = yx3.reshape(B, d.n)
    yZ, Xa = yx[:K], yx[K:]
    ywZ, Wa = yw2[:K], yw2[K:]
    if ncon > 0:
        G_lu = _g_factor(torch.diag(Gamma) + gram[K:, K:], ncon)
        pz = _g_solve_rows(G_lu, -gram[K:, :K].T, ncon)      # [K, ncon]
        Phi_x = yZ + pz @ Xa
        Phi_w = ywZ + pz @ Wa
        Phi_z = pz
        Ce = Mqn - (gram[:K, :K] + gram[:K, K:] @ pz.T)
    else:
        G_lu = None
        Phi_x, Phi_w = yZ, ywZ
        Phi_z = torch.zeros((K, 0), dtype=dtype, device=Dinv.device)
        Ce = Mqn - gram[:K, :K]
    return KKTFactor(Dinv=Dinv, Gamma=Gamma, C0=C0, Cw_chol=Cw_chol,
                     Xa=Xa, Wa=Wa, G_lu=G_lu, Zqn=Zqn, Phi_x=Phi_x,
                     Phi_z=Phi_z, Phi_w=Phi_w,
                     Ce_inv=torch.linalg.inv_ex(Ce).inverse)


def _solve_diag3(f: KKTFactor, d: ProblemData, bx, bc, bw):
    """Solve [[H0, -A', -Aw'], [A, Γ, 0], [Aw, 0, C0]] p = [bx; bc; bw],
    batched over a leading axis when present."""
    px0, pw0 = quasi_def_solve(f, d, bx, bw)
    if d.ncon == 0:
        return px0, bc, pw0
    batched = bx.dim() > 1
    rhs = bc - px0 @ d.A.T if batched else bc - d.A @ px0
    if d.ncon <= 2 and not batched:
        pz = f.G_lu @ rhs
    else:
        pz = _g_solve_rows(f.G_lu, rhs, d.ncon)
    if batched:
        return px0 + pz @ f.Xa, pz, pw0 + pz @ f.Wa
    return px0 + f.Xa.T @ pz, pz, pw0 + f.Wa.T @ pz


def _solve_reduced(f: KKTFactor, d: ProblemData, bx, bc, bw):
    """Full reduced solve including the SMW quasi-Newton correction."""
    px, pz, pw = _solve_diag3(f, d, bx, bc, bw)
    if f.Zqn is not None:
        y = f.Ce_inv @ matmul(f.Zqn, px)
        px = px + matmul(f.Phi_x.T, y)
        pz = pz + matmul(f.Phi_z.T, y)
        pw = pw + matmul(f.Phi_w.T, y)
    return px, pz, pw


def reduced_rhs(v: IPVars, d: ProblemData, r: IPVars):
    """Condense K p = -r to the 3x3 system right-hand sides (bx, bc, bcw)."""
    ql_den = torch.where(d.lb_mask > 0, v.x - d.lb, 1.0)
    qu_den = torch.where(d.ub_mask > 0, d.ub - v.x, 1.0)
    bx = (-r.x - torch.where(d.lb_mask > 0, r.zl / ql_den, 0.0)
          + torch.where(d.ub_mask > 0, r.zu / qu_den, 0.0))
    bc = -r.z - (r.zs + v.s * r.s) / v.zs + (r.zt + v.t * r.t) / v.zt
    bcw = (-r.zw - (r.zsw + v.sw * r.sw) / v.zsw
           + (r.ztw + v.tw * r.tw) / v.ztw)
    return bx, bc, bcw


def recover_full_step(v: IPVars, d: ProblemData, r: IPVars,
                      px, pz, pzw) -> IPVars:
    """Back-substitute the eliminated variables given (px, pz, pzw)."""
    ql_den = torch.where(d.lb_mask > 0, v.x - d.lb, 1.0)
    qu_den = torch.where(d.ub_mask > 0, d.ub - v.x, 1.0)
    pzl = torch.where(d.lb_mask > 0, -(r.zl + v.zl * px) / ql_den, -v.zl)
    pzu = torch.where(d.ub_mask > 0, -(r.zu - v.zu * px) / qu_den, -v.zu)
    pzs = pz + r.s
    pzt = r.t - pz
    pzsw = pzw + r.sw
    pztw = r.tw - pzw
    return IPVars(
        x=px, zl=pzl, zu=pzu,
        s=-(r.zs + v.s * pzs) / v.zs, t=-(r.zt + v.t * pzt) / v.zt,
        z=pz, zs=pzs, zt=pzt,
        sw=-(r.zsw + v.sw * pzsw) / v.zsw, tw=-(r.ztw + v.tw * pztw) / v.ztw,
        zw=pzw, zsw=pzsw, ztw=pztw)


def solve_kkt(v: IPVars, d: ProblemData, f: KKTFactor, r: IPVars,
              refine_steps: int = 0, qn_compact=None) -> IPVars:
    """Solve the Newton system K p = -r for the full step, with optional
    iterative refinement."""
    p = recover_full_step(v, d, r,
                          *_solve_reduced(f, d, *reduced_rhs(v, d, r)))
    for _ in range(refine_steps):
        Kp = apply_kkt_matrix(v, d, p, qn_compact)
        # rr = -r - K p; correct with K dp = rr (= -(-rr))
        neg_rr = tmap(lambda ri, kpi: ri + kpi, r, Kp)
        dp = recover_full_step(
            v, d, neg_rr, *_solve_reduced(f, d, *reduced_rhs(v, d, neg_rr)))
        p = tmap(torch.add, p, dp)
    return p


def apply_kkt_matrix(v: IPVars, d: ProblemData, p: IPVars,
                     qn_compact=None, qn_sigma: float = 0.0,
                     hvp: Optional[torch.Tensor] = None) -> IPVars:
    """Apply the full Newton/KKT matrix K to a step p (field mapping as in
    `kkt_residual`); the Hessian block is B·px from the compact QN or an
    explicit Hessian-vector product ``hvp``."""
    if hvp is not None:
        Bpx = hvp + qn_sigma * p.x
    elif qn_compact is not None:
        b0, Z, M = qn_compact
        Bpx = (b0 + qn_sigma) * p.x
        if Z is not None and Z.shape[0] > 0:
            Bpx = Bpx - matmul(
                Z.T, torch.linalg.solve_ex(M, matmul(Z, p.x)).result)
    else:
        Bpx = (1.0 + qn_sigma) * p.x
    kx = Bpx - d.A.T @ p.z - p.zl + p.zu
    if d.nwcon > 0:
        kx = kx - d.Aw_rmatvec(p.zw)
        kcw = d.Aw_matvec(p.x) - p.sw + p.tw
    else:
        kcw = p.x.new_zeros(0) - p.sw + p.tw
    return IPVars(
        x=kx,
        zl=torch.where(d.lb_mask > 0, v.zl * p.x + (v.x - d.lb) * p.zl, p.zl),
        zu=torch.where(d.ub_mask > 0, -v.zu * p.x + (d.ub - v.x) * p.zu,
                       p.zu),
        s=p.z - p.zs, t=-p.z - p.zt, z=d.A @ p.x - p.s + p.t,
        zs=v.zs * p.s + v.s * p.zs, zt=v.zt * p.t + v.t * p.zt,
        sw=p.zw - p.zsw, tw=-p.zw - p.ztw, zw=kcw,
        zsw=v.zsw * p.sw + v.sw * p.zsw, ztw=v.ztw * p.tw + v.tw * p.ztw)


# ---------------------------------------------------------------------------
# step-length computation
# ---------------------------------------------------------------------------


def _max_alpha_pos(val, step, tau, mask=None):
    """max α ∈ (0, 1] keeping val + α·step >= (1-τ)·val (val > 0); inf for
    an empty array (torch.min refuses one)."""
    if val.numel() == 0:
        return torch.full((), float("inf"), dtype=val.dtype,
                          device=val.device)
    neg = step < 0
    ratio = torch.where(neg, -tau * val / torch.where(neg, step, -1.0),
                        float("inf"))
    if mask is not None:
        ratio = torch.where(mask > 0, ratio, float("inf"))
    return torch.min(ratio)


def max_step_lengths(v: IPVars, d: ProblemData, p: IPVars, tau):
    """Fraction-to-boundary maximum primal/dual steps (`computeMaxStep`)."""
    one = torch.ones((), dtype=v.x.dtype, device=v.x.device)
    ax = torch.minimum(one, _max_alpha_pos(v.x - d.lb, p.x, tau, d.lb_mask))
    ax = torch.minimum(ax, _max_alpha_pos(d.ub - v.x, -p.x, tau, d.ub_mask))
    for val, st in ((v.s, p.s), (v.t, p.t), (v.sw, p.sw), (v.tw, p.tw)):
        ax = torch.minimum(ax, _max_alpha_pos(val, st, tau))
    az = one
    for val, st, mask in ((v.zl, p.zl, d.lb_mask), (v.zu, p.zu, d.ub_mask),
                          (v.zs, p.zs, None), (v.zt, p.zt, None),
                          (v.zsw, p.zsw, None), (v.ztw, p.ztw, None)):
        az = torch.minimum(az, _max_alpha_pos(val, st, tau, mask))
    return ax, az


def average_complementarity(v: IPVars, d: ProblemData):
    """Average complementarity products (`computeComp`)."""
    total = (torch.sum(torch.where(d.lb_mask > 0, (v.x - d.lb) * v.zl, 0.0))
             + torch.sum(torch.where(d.ub_mask > 0, (d.ub - v.x) * v.zu,
                                     0.0)))
    count = torch.sum(d.lb_mask) + torch.sum(d.ub_mask)
    if d.ncon > 0:
        total = total + torch.sum(v.s * v.zs) + torch.sum(v.t * v.zt)
        count = count + 2.0 * d.ncon
    if d.nwcon > 0:
        total = total + torch.sum(v.sw * v.zsw) + torch.sum(v.tw * v.ztw)
        count = count + 2.0 * d.nwcon
    return total / torch.clamp(count, min=1.0)
