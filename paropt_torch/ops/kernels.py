"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions
(counterpart of paropt_tpu/ops/pallas_kernels.py).

Each of the three Pallas kernels has here:

- a wrapper that checks device, dtype, shape and contiguity, allocates the
  outputs (and the cross-block partial sums) with ``torch.empty`` and
  launches on the current stream.  A CPU tensor goes to the plain version;
  a CUDA tensor launches the kernel or raises — there is no fallback;
- the plain PyTorch version of the same function;
- a launch count in ``LAUNCHES``, raised by one where the wrapper launches
  its kernel and nowhere else.

The kernels live in ``paropt_torch/csrc`` (``qn_roll.cu``,
``quasi_def.cu``) and are built by ``_build.load_library`` on first use.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["LAUNCHES", "reset_launches", "qn_roll_update",
           "qn_roll_update_plain", "quasi_def_apply", "quasi_def_apply_plain",
           "phi_gram", "phi_gram_plain"]

# kernel name -> launches since the last reset_launches()
LAUNCHES = {"qn_roll_update": 0, "quasi_def_apply": 0, "phi_gram": 0}

_SUFFIX = {torch.float32: "f32", torch.float64: "f64", torch.bfloat16: "bf16"}
_SMEM_BYTES = 48 * 1024   # phi_gram's shared stage (no opt-in needed)
_MAX_GRID = 1024          # phi_gram's block count cap (fixed, so bitwise
#                           reproducible for a given shape)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _route(*tensors: torch.Tensor) -> str:
    """'cpu' (plain version) or 'cuda' (kernel); anything else raises."""
    dev = tensors[0].device
    _require(all(t.device == dev for t in tensors),
             "all tensors must be on one device")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type


def _launch(name: str, fn, device: torch.device, *args) -> None:
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
    LAUNCHES[name] += 1


def _lib():
    from ._build import load_library
    return load_library()


# ---------------------------------------------------------------------------
# 1. quasi-Newton ring-buffer roll + select + Gram dots
# ---------------------------------------------------------------------------


def _acc_dtype(storage: torch.dtype) -> torch.dtype:
    return torch.float32 if torch.finfo(storage).bits < 32 else storage


def qn_roll_update_plain(buf: torch.Tensor, s: torch.Tensor, y: torch.Tensor,
                         upd: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """rolled = [buf[1:m]; s; buf[m+1:]; y]; out = upd ? rolled : buf;
    dots = rolled @ [s, y]ᵀ.  s and y are quantized to buf's dtype first;
    narrow storage accumulates the dots in f32 from the quantized values."""
    m = buf.shape[0] // 2
    s_q = s.to(buf.dtype)
    y_q = y.to(buf.dtype)
    rolled = torch.cat([buf[1:m], s_q[None], buf[m + 1:], y_q[None]])
    out = torch.where(upd, rolled, buf)
    acc = _acc_dtype(buf.dtype)
    dots = rolled.to(acc) @ torch.stack([s_q, y_q]).to(acc).T
    return out, dots


def qn_roll_update(buf: torch.Tensor, s: torch.Tensor, y: torch.Tensor,
                   upd: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused roll/select/dots over the stacked [2m, n] S/Y buffer
    (replaces `qn_roll_update`, pallas_kernels.py:68-149).

    ``upd`` is a 0-d bool tensor on the buffer's device; the kernel reads it
    there (no host sync).  The roll is out of place: ``buf`` is unchanged.
    Returns (buf_out [2m, n], dots [2m, 2] in f32 for narrow storage, else
    in the buffer's dtype)."""
    _require(buf.dim() == 2 and buf.shape[0] % 2 == 0 and buf.shape[0] >= 2,
             f"buf must be [2m, n], got {tuple(buf.shape)}")
    rows, n = buf.shape
    _require(s.shape == (n,) and y.shape == (n,),
             "s and y must be [n] matching buf")
    _require(upd.dim() == 0 and upd.dtype == torch.bool,
             "upd must be a 0-d bool tensor")
    if _route(buf, s, y, upd) == "cpu":
        return qn_roll_update_plain(buf, s, y, upd)
    _require(buf.dtype in _SUFFIX, f"unsupported buffer dtype {buf.dtype}")
    _require(buf.is_contiguous(), "buf must be contiguous")
    s_q = s.to(buf.dtype).contiguous()
    y_q = y.to(buf.dtype).contiguous()
    lib = _lib()
    acc = _acc_dtype(buf.dtype)
    tile = lib.paropt_qn_roll_tile()
    nblocks = max(1, -(-n // tile))
    out = torch.empty_like(buf)
    partials = torch.empty((nblocks, rows, 2), dtype=acc, device=buf.device)
    dots = torch.empty((rows, 2), dtype=acc, device=buf.device)
    fn = getattr(lib, f"paropt_qn_roll_update_{_SUFFIX[buf.dtype]}")
    _launch("qn_roll_update", fn, buf.device,
            *(t.data_ptr() for t in (buf, s_q, y_q, upd, out, partials, dots)),
            rows // 2, n, nblocks)
    return out, dots


# ---------------------------------------------------------------------------
# 2./3. quasi-definite apply (blocked_t, nwblock == 1) and the fused factor
# ---------------------------------------------------------------------------


def quasi_def_apply_plain(dinv2, cwinv, vals_t, bx3, bw2):
    """t = Dinv⊙bx; aw = Σ_j vals[j]⊙t[j]; yw = cwinv⊙(bw − aw);
    yx = Dinv⊙(bx + vals⊙yw), for K stacked right-hand sides."""
    t = dinv2[None] * bx3
    aw = torch.sum(vals_t[None] * t, dim=1)
    yw = cwinv * (bw2 - aw)
    yx = dinv2[None] * (bx3 + vals_t[None] * yw[:, None, :])
    return yx, yw


def phi_gram_plain(dinv2, cwinv, vals_t, bx3, bw2):
    """The quasi-definite apply plus gram[a, b] = bx_a · yx_b."""
    yx, yw = quasi_def_apply_plain(dinv2, cwinv, vals_t, bx3, bw2)
    B = bx3.shape[0]
    gram = bx3.reshape(B, -1) @ yx.reshape(B, -1).T
    return yx, yw, gram


def _check_qd(dinv2, cwinv, vals_t, bx3, bw2) -> str:
    _require(dinv2.dim() == 2, "dinv must be [k, nwcon]")
    k, W = dinv2.shape
    _require(vals_t.shape == (k, W), "vals_t must be [k, nwcon]")
    _require(cwinv.shape == (W,), "cwinv must be [nwcon]")
    _require(bx3.dim() == 3 and bx3.shape[1:] == (k, W),
             "bx must be [K, k, nwcon]")
    _require(bw2.shape == (bx3.shape[0], W), "bw must be [K, nwcon]")
    dt = dinv2.dtype
    _require(all(t.dtype == dt for t in (cwinv, vals_t, bx3, bw2)),
             "all operands must share one dtype")
    route = _route(dinv2, cwinv, vals_t, bx3, bw2)
    if route == "cuda":
        _require(dt in (torch.float32, torch.float64),
                 f"unsupported dtype {dt}")
        _require(all(t.is_contiguous()
                     for t in (dinv2, cwinv, vals_t, bx3, bw2)),
                 "all operands must be contiguous")
    return route


def quasi_def_apply(dinv2, cwinv, vals_t, bx3, bw2):
    """Fused solve of [[D, -Aw'], [Aw, C0]] [yx; yw] = [bx; bw] in the
    (nwblock=1, blocked_t) view (replaces `quasi_def_apply_blocked_t`,
    pallas_kernels.py:258-304).  Shapes: dinv2, vals_t [k, nwcon]; cwinv
    [nwcon]; bx3 [K, k, nwcon]; bw2 [K, nwcon].  Returns (yx3, yw2)."""
    if _check_qd(dinv2, cwinv, vals_t, bx3, bw2) == "cpu":
        return quasi_def_apply_plain(dinv2, cwinv, vals_t, bx3, bw2)
    K, k, W = bx3.shape
    yx = torch.empty_like(bx3)
    yw = torch.empty_like(bw2)
    fn = getattr(_lib(), f"paropt_quasi_def_apply_{_SUFFIX[bx3.dtype]}")
    _launch("quasi_def_apply", fn, bx3.device,
            *(t.data_ptr() for t in (dinv2, cwinv, vals_t, bx3, bw2, yx, yw)),
            K, k, W)
    return yx, yw


def phi_gram_tile(B: int, k: int, itemsize: int) -> int:
    """Columns per shared-memory tile of the fused factor kernel: the stage
    holds bx and yx for the tile ([B·k, tile+1] each) and the per-block
    [B, B] Gram sum, within 48 KB."""
    budget = _SMEM_BYTES // itemsize - B * B
    tw = min(32, budget // (2 * B * k) - 1)
    _require(tw >= 1, f"stack too tall for the shared stage (B={B}, k={k})")
    return tw


def phi_gram(dinv2, cwinv, vals_t, bx3, bw2):
    """Quasi-definite solve of the [B, k, nwcon] stack plus the [B, B] Gram
    matrix gram[a, b] = bx_a · yx_b in one sweep (replaces
    `phi_gram_blocked_t`, pallas_kernels.py:210-255).
    Returns (yx3 [B, k, nwcon], yw [B, nwcon], gram [B, B])."""
    if _check_qd(dinv2, cwinv, vals_t, bx3, bw2) == "cpu":
        return phi_gram_plain(dinv2, cwinv, vals_t, bx3, bw2)
    B, k, W = bx3.shape
    tw = phi_gram_tile(B, k, bx3.element_size())
    nblocks = max(1, min(-(-W // tw), _MAX_GRID))
    yx = torch.empty_like(bx3)
    yw = torch.empty_like(bw2)
    partials = torch.empty((nblocks, B, B), dtype=bx3.dtype,
                           device=bx3.device)
    gram = torch.empty((B, B), dtype=bx3.dtype, device=bx3.device)
    fn = getattr(_lib(), f"paropt_phi_gram_{_SUFFIX[bx3.dtype]}")
    _launch("phi_gram", fn, bx3.device,
            *(t.data_ptr() for t in (dinv2, cwinv, vals_t, bx3, bw2, yx, yw,
                                     partials, gram)),
            B, k, W, tw, nblocks)
    return yx, yw, gram
