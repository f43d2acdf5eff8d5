"""Compact limited-memory quasi-Newton Hessian approximations (counterpart of
paropt_tpu/ops/qn.py).

    B  ≈  b0 * I  -  Z^T M^{-1} Z

The (s, y) history lives in ONE [2m, n] ring buffer (rows [:m] = S, rows
[m:] = Y, newest pair in rows m-1 / 2m-1), so the BFGS compact form's
Z = [S; Y] is the buffer itself and the b0 scaling lives in the small M
(`_assemble_M`).  L-SR1 uses W = Y - b0 S and M = b0 S Sᵀ - D - L - Lᵀ.

`qn_update` has the two branches of the JAX version: on a CUDA buffer the
roll, select and Gram dots are one sweep of the `qn_roll_update` kernel and
the b0 scalars come from its [2m, 2] dots; on the CPU the plain chain runs
and the b0 scalars come from separate dot products.  The two sum in
different orders, and that difference is kept on purpose: switching the b0
source changed SR1 trajectories in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..dtypes import resolve_device, resolve_dtype
from ..tree import pytree, static_field
from . import kernels
from .veclib import dot, matmul

__all__ = ["QNState", "qn_init", "qn_reset", "qn_update", "qn_mult",
           "qn_compact", "default_storage_dtype", "resolve_subspace_size"]


@pytree
@dataclasses.dataclass(frozen=True)
class QNState:
    """Fixed-shape limited-memory state.  ``buf`` may be stored narrower
    (e.g. bfloat16) than the small matrices; the Gram matrices are then
    formed from the QUANTIZED pairs, so the compact form stays exactly
    consistent with the stored Z."""
    buf: torch.Tensor       # [2m, n] stacked S/Y ring buffers
    SS: torch.Tensor        # [m, m] Gram S·Sᵀ
    SY: torch.Tensor        # [m, m] SY[i, j] = s_i · y_j
    count: torch.Tensor     # int32 scalar, number of active pairs (<= m)
    b0: torch.Tensor        # scalar initial diagonal
    z0: torch.Tensor        # objective-multiplier scale (scaled_bfgs only)
    qn_type: str = static_field("bfgs")
    update_type: str = static_field("skip_negative_curvature")
    diag_type: str = static_field("yty_over_yts")
    scaled: bool = static_field(False)

    @property
    def S(self) -> torch.Tensor:
        return self.buf[:self.msub]

    @property
    def Y(self) -> torch.Tensor:
        return self.buf[self.msub:]

    @property
    def msub(self) -> int:
        return self.buf.shape[0] // 2

    @property
    def nvars(self) -> int:
        return self.buf.shape[1]


def default_storage_dtype(compute_dtype):
    """The QN-storage policy: native storage (None) on every device.

    The JAX package stores the ring buffer in bfloat16 at f32 on a TPU, a
    choice made by a TPU A/B (`paropt_tpu/ops/qn.py:98-110`).  Whether
    bf16 storage pays on the H100 is an open measurement; until it is made
    the port keeps full-precision history.  ``storage_dtype`` in `qn_init`
    still selects bf16 explicitly."""
    return None


def resolve_subspace_size(requested: int, auto: bool, nvars: int,
                          compute_dtype) -> int:
    """qn_subspace_auto policy: cap the subspace at 5 once the problem is
    bandwidth-bound (nvars >= 2^19) in 32-bit or narrower precision; small
    problems and f64 keep the requested size."""
    if not auto:
        return requested
    if nvars >= (1 << 19) and compute_dtype.itemsize <= 4:
        return min(requested, 5)
    return requested


def qn_init(msub: int, nvars: int, dtype=None, qn_type: str = "bfgs",
            update_type: str = "skip_negative_curvature",
            diag_type: str = "yty_over_yts", b0: float = 1.0,
            storage_dtype=None, device=None) -> QNState:
    """``storage_dtype``: dtype of the [2m, n] ring buffer only; the small
    matrices and scalars stay in ``dtype``."""
    dtype = resolve_dtype(dtype)
    device = resolve_device(device)
    sdtype = dtype if storage_dtype is None else storage_dtype
    scaled = qn_type == "scaled_bfgs"
    kw = dict(dtype=dtype, device=device)
    return QNState(
        buf=torch.zeros((2 * msub, nvars), dtype=sdtype, device=device),
        SS=torch.zeros((msub, msub), **kw),
        SY=torch.zeros((msub, msub), **kw),
        count=torch.zeros((), dtype=torch.int32, device=device),
        b0=torch.tensor(b0, **kw),
        z0=torch.ones((), **kw),
        qn_type="bfgs" if scaled else qn_type,
        update_type=update_type, diag_type=diag_type, scaled=scaled)


def qn_reset(state: QNState) -> QNState:
    return dataclasses.replace(
        state, buf=torch.zeros_like(state.buf),
        SS=torch.zeros_like(state.SS), SY=torch.zeros_like(state.SY),
        count=torch.zeros_like(state.count), b0=torch.ones_like(state.b0))


def _active_mask(state: QNState) -> torch.Tensor:
    m = state.msub
    idx = torch.arange(m, device=state.SS.device)
    return (idx >= m - state.count).to(state.SS.dtype)


def _assemble_M(state: QNState, b0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Z [K, n], M [K, K]) for B = b0 I - Z^T M^{-1} Z, inactive rows
    padded with identity on the M diagonal.  BFGS: Z = [S; Y] (zero-copy),
    M = [[SSᵀ/b0, L/b0], [Lᵀ/b0, -D]]."""
    SS = state.SS
    SY = state.SY
    mask = _active_mask(state)
    D = torch.diag(torch.diag(SY))
    Lmat = torch.tril(SY, diagonal=-1)      # strictly lower: s_i.y_j, i > j
    if state.qn_type in ("bfgs", "scaled_bfgs"):
        Z = state.buf
        M = torch.cat([torch.cat([SS / b0, Lmat / b0], dim=1),
                       torch.cat([Lmat.T / b0, -D], dim=1)], dim=0)
        act = torch.cat([mask, mask])
    elif state.qn_type == "sr1":
        dt = SS.dtype
        Z = state.Y.to(dt) - b0 * state.S.to(dt)
        M = b0 * SS - D - Lmat - Lmat.T
        act = mask
    else:
        raise ValueError(f"unknown qn_type {state.qn_type!r}")
    # inactive S/Y rows are zero by construction, so Z needs no masking
    K = M.shape[0]
    eye = torch.eye(K, dtype=M.dtype, device=M.device)
    outer = act[:, None] * act[None, :]
    return Z, torch.where(outer > 0, M, eye)


def qn_compact(state: QNState):
    """-> (b0, Z [K, n], M [K, K]) with B = b0 I - Z^T M^{-1} Z.  The
    scaled-BFGS decorator scales by the objective multiplier:
    B = z0·b0·I - Zᵀ(M/z0)⁻¹Z."""
    Z, M = _assemble_M(state, state.b0)
    if state.scaled:
        return state.z0 * state.b0, Z, M / state.z0
    return state.b0, Z, M


def qn_mult(state: QNState, x: torch.Tensor, compact=None) -> torch.Tensor:
    """B @ x.  Pass a precomputed ``compact`` to avoid re-assembly."""
    b0, Z, M = compact if compact is not None else qn_compact(state)
    return b0 * x - matmul(Z.T, torch.linalg.solve_ex(M, matmul(Z, x)).result)


def _new_b0(state: QNState, yTs, yTy, sTs):
    # reference quirk preserved (`ParOptQuasiNewton.cpp:200-203`): ONLY the
    # exact 'yts_over_sts' selects yTs/sTs
    if state.diag_type == "yts_over_sts":
        val = yTs / sTs
    else:
        val = yTy / yTs
    return torch.where(yTs > 0.0, val, state.b0)


def _roll_border(G, col, row):
    """G rolled by (-1, -1) with its last column set to ``col`` and then
    its last row to ``row``."""
    inner = G[1:, 1:]
    return torch.cat([torch.cat([inner, col[:-1, None]], dim=1),
                      row[None, :]], dim=0)


def qn_update(state: QNState, s: torch.Tensor, y: torch.Tensor,
              z0: Optional[torch.Tensor] = None, compact=None,
              accept=None) -> Tuple[QNState, torch.Tensor, torch.Tensor]:
    """Apply one (s, y) update; returns (new_state, skipped, damped) with
    int32 flags.  The ladder follows `ParOptQuasiNewton.cpp:130-280`:

    - skip when |yᵀs| <= 1e-8 · yᵀy;
    - 'damped_update' (BFGS): θ = 0.8·sᵀBs/(sᵀBs − yᵀs) when
      yᵀs < 0.2·sᵀBs, y ← θ·y + (1−θ)·Bs;
    - 'skip_negative_curvature' (BFGS): skip when yᵀs <= 0;
    - SR1: skip when |sᵀ(y − Bs)| is small relative to |s|·|y − Bs|.

    ``accept`` (bool scalar) gates the whole update in the same select.
    A CUDA buffer takes the kernel branch, a CPU buffer the plain one."""
    return _qn_update(state, s, y, z0, compact, accept,
                      kernel_branch=state.buf.is_cuda)


def _qn_update(state: QNState, s, y, z0, compact, accept,
               kernel_branch: bool):
    dtype = state.SS.dtype
    dev = state.SS.device
    s = s.to(dtype)
    y = y.to(dtype)
    z0_old = state.z0
    need_Bs = state.qn_type == "sr1" or state.update_type == "damped_update"
    if state.scaled:
        # the inner approximation models the Lagrangian Hessian divided by
        # the objective multiplier z0 (`ParOptScaledQuasiNewton.h:22-103`)
        z0_new = (torch.clamp(torch.abs(torch.as_tensor(z0, dtype=dtype,
                                                        device=dev)),
                              min=1e-8)
                  if z0 is not None else state.z0)
        state = dataclasses.replace(state, z0=z0_new)
        y = y / z0_new
        Bs = (qn_mult(dataclasses.replace(state, scaled=False), s)
              if need_Bs else torch.zeros_like(s))
    else:
        Bs = (qn_mult(state, s, compact=compact) if need_Bs
              else torch.zeros_like(s))
    # one stacked reduction for all the scalars (mdot pattern)
    if need_Bs:
        G = torch.stack([s, y, Bs]) @ torch.stack([s, y]).T   # [3, 2]
        sTs, yTs, yTy, sBs = G[0, 0], G[1, 0], G[1, 1], G[2, 0]
    else:
        G = torch.stack([s, y]) @ torch.stack([s, y]).T       # [2, 2]
        sTs, yTs, yTy = G[0, 0], G[1, 0], G[1, 1]
        sBs = torch.zeros((), dtype=dtype, device=dev)

    false = torch.zeros((), dtype=torch.bool, device=dev)
    if state.qn_type in ("bfgs", "scaled_bfgs"):
        nocedal_skip = torch.abs(yTs) <= 1e-8 * yTy
        if state.update_type == "damped_update":
            need_damp = yTs < 0.2 * sBs
            theta = torch.where(need_damp, 0.8 * sBs / (sBs - yTs), 1.0)
            y_use = theta * y + (1.0 - theta) * Bs
            damped = need_damp & ~nocedal_skip
            skip = nocedal_skip
        else:
            y_use = y
            damped = false
            skip = nocedal_skip | (yTs <= 0.0)
    else:  # sr1
        w = y - Bs
        sw = dot(s, w)
        skip = torch.abs(sw) <= 1e-8 * torch.sqrt(sTs * dot(w, w) + 1e-300)
        y_use = y
        damped = false

    upd = ~skip
    if accept is not None:
        upd = upd & torch.as_tensor(accept, device=dev).to(torch.bool)

    m = state.msub
    # narrow storage: re-apply the curvature gate to the QUANTIZED scalars
    # (BFGS forms only; SR1's M may be indefinite)
    q_narrow = (state.buf.dtype != dtype
                and state.qn_type in ("bfgs", "scaled_bfgs"))
    q_reject = false
    if kernel_branch:
        if q_narrow:
            s_q = s.to(state.buf.dtype).to(dtype)
            y_q = y_use.to(state.buf.dtype).to(dtype)
            q_reject = dot(y_q, s_q) <= 1e-8 * dot(y_q, y_q)
            upd = upd & ~q_reject
        buf_sel, dots = kernels.qn_roll_update(state.buf, s, y_use, upd)
        dots = dots.to(dtype)
        # rows m-1 / 2m-1 carry every scalar the b0 update needs
        sTs_u, yTs_use, yTy_use = dots[m - 1, 0], dots[m - 1, 1], dots[-1, 1]
    else:
        if state.buf.dtype != dtype:
            s_st = s.to(state.buf.dtype)
            y_st = y_use.to(state.buf.dtype)
            s_g = s_st.to(dtype)
            y_g = y_st.to(dtype)
        else:
            s_st, y_st, s_g, y_g = s, y_use, s, y_use
        buf_new = torch.cat([state.buf[1:m], s_st[None, :],
                             state.buf[m + 1:], y_st[None, :]])
        dots = matmul(buf_new, torch.stack([s_g, y_g]).T)    # [2m, 2]
        sTs_u = sTs if s_g is s else dot(s_g, s_g)
        yTs_use = dot(y_g, s_g)
        yTy_use = dot(y_g, y_g)
        if q_narrow:
            q_reject = yTs_use <= 1e-8 * yTy_use
            upd = upd & ~q_reject
        buf_sel = torch.where(upd, buf_new, state.buf)
    Ss = dots[:m, 0]          # S_new · s
    Sy = dots[:m, 1]          # S_new · y_use  (new SY column)
    Ys = dots[m:, 0]          # Y_new · s      (new SY row)

    b0_new = _new_b0(state, yTs_use, yTy_use, sTs_u)
    if state.qn_type == "sr1":
        b0_new = torch.where(b0_new > 0.0, b0_new, state.b0)

    cnt_new = torch.clamp(state.count + 1, max=m)
    # the rolled Gram matrices with the new pair in the last row and
    # column, built out of place (a write into the rolled copy could not
    # take a per-instance value under vmap when the old state is shared)
    SS_new = _roll_border(state.SS, Ss, Ss)
    SY_new = _roll_border(state.SY, Sy, Ys)

    new_state = dataclasses.replace(
        state, buf=buf_sel,
        SS=torch.where(upd, SS_new, state.SS),
        SY=torch.where(upd, SY_new, state.SY),
        count=torch.where(upd, cnt_new, state.count),
        b0=torch.where(upd, b0_new, state.b0))
    if state.scaled and accept is not None:
        # a rejected step must not move the z0 refresh either
        acc = torch.as_tensor(accept, device=dev).to(torch.bool)
        new_state = dataclasses.replace(
            new_state, z0=torch.where(acc, new_state.z0, z0_old))
    skip = skip | q_reject
    damped = damped & ~q_reject
    return new_state, skip.to(torch.int32), damped.to(torch.int32)
