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

from typing import NamedTuple, Tuple

import torch

__all__ = ["LAUNCHES", "reset_launches", "qn_roll_update",
           "qn_roll_update_plain", "quasi_def_apply", "quasi_def_apply_plain",
           "phi_gram", "phi_gram_plain", "phi_gram_plan", "phi_gram_tile"]

# kernel name -> launches since the last reset_launches()
LAUNCHES = {"qn_roll_update": 0, "quasi_def_apply": 0, "phi_gram": 0}

_SUFFIX = {torch.float32: "f32", torch.float64: "f64", torch.bfloat16: "bf16"}
# phi_gram's shared memory: an SM has 228 KB, of which the runtime keeps
# 1 KB per resident block; one block may opt in to at most 227 KB
_SM_SMEM_BYTES = 228 * 1024
_BLOCK_SMEM_BYTES = 227 * 1024
_PG_THREADS = 256         # phi_gram's block size (kPgThreads)
_PG_STAGES = 2            # phi_gram's ring of staged tiles (kPgStages)


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


def quasi_def_apply_plain(dinv2, cwinv, vals_t, bx3, bw2=None):
    """t = Dinv⊙bx; aw = Σ_j vals[j]⊙t[j]; yw = cwinv⊙(bw − aw);
    yx = Dinv⊙(bx + vals⊙yw), for K stacked right-hand sides (bw2 None
    means zero)."""
    t = dinv2[None] * bx3
    aw = torch.sum(vals_t[None] * t, dim=1)
    yw = cwinv * (-aw if bw2 is None else bw2 - aw)
    yx = dinv2[None] * (bx3 + vals_t[None] * yw[:, None, :])
    return yx, yw


def phi_gram_plain(dinv2, cwinv, vals_t, bx3, bw2=None, bx3_tail=None):
    """The quasi-definite apply of the stack [bx3; bx3_tail] plus
    gram[a, b] = bx_a · yx_b."""
    if bx3_tail is not None:
        bx3 = torch.cat([bx3, bx3_tail])
    yx, yw = quasi_def_apply_plain(dinv2, cwinv, vals_t, bx3, bw2)
    B = bx3.shape[0]
    gram = bx3.reshape(B, -1) @ yx.reshape(B, -1).T
    return yx, yw, gram


def _check_qd(dinv2, cwinv, vals_t, bx3, bw2, bx3_tail=None) -> str:
    _require(dinv2.dim() == 2, "dinv must be [k, nwcon]")
    k, W = dinv2.shape
    _require(vals_t.shape == (k, W), "vals_t must be [k, nwcon]")
    _require(cwinv.shape == (W,), "cwinv must be [nwcon]")
    _require(bx3.dim() == 3 and bx3.shape[1:] == (k, W),
             "bx must be [K, k, nwcon]")
    ops = [dinv2, cwinv, vals_t, bx3]
    B = bx3.shape[0]
    if bx3_tail is not None:
        _require(bx3_tail.dim() == 3 and bx3_tail.shape[1:] == (k, W),
                 "bx_tail must be [K2, k, nwcon]")
        B += bx3_tail.shape[0]
        ops.append(bx3_tail)
    if bw2 is not None:
        _require(bw2.shape == (B, W), "bw must be [K, nwcon]")
        ops.append(bw2)
    dt = dinv2.dtype
    _require(all(t.dtype == dt for t in ops),
             "all operands must share one dtype")
    route = _route(*ops)
    if route == "cuda":
        _require(dt in (torch.float32, torch.float64),
                 f"unsupported dtype {dt}")
        _require(all(t.is_contiguous() for t in ops),
                 "all operands must be contiguous")
    return route


def _aligned16(*tensors) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors if t is not None)


def _ptr(t):
    return None if t is None else t.data_ptr()


def quasi_def_apply(dinv2, cwinv, vals_t, bx3, bw2):
    """Fused solve of [[D, -Aw'], [Aw, C0]] [yx; yw] = [bx; bw] in the
    (nwblock=1, blocked_t) view (replaces `quasi_def_apply_blocked_t`,
    pallas_kernels.py:258-304).  Shapes: dinv2, vals_t [k, nwcon]; cwinv
    [nwcon]; bx3 [K, k, nwcon]; bw2 [K, nwcon].  Returns (yx3, yw2)."""
    _require(bw2 is not None, "bw must be [K, nwcon]")
    if _check_qd(dinv2, cwinv, vals_t, bx3, bw2) == "cpu":
        return quasi_def_apply_plain(dinv2, cwinv, vals_t, bx3, bw2)
    K, k, W = bx3.shape
    yx = torch.empty_like(bx3)
    yw = torch.empty_like(bw2)
    ops = (dinv2, cwinv, vals_t, bx3, bw2, yx, yw)
    # 16-byte vectors: 4 columns in f32, 2 in f64
    vec = W % (16 // bx3.element_size()) == 0 and _aligned16(*ops)
    fn = getattr(_lib(), f"paropt_quasi_def_apply_{_SUFFIX[bx3.dtype]}")
    _launch("quasi_def_apply", fn, bx3.device,
            *(t.data_ptr() for t in ops), K, k, W, int(vec))
    return yx, yw


class PhiGramPlan(NamedTuple):
    """How `phi_gram` lays a [B, k, nwcon] stack out on the card."""
    tile: int           # columns per tile (a multiple of 4)
    bpad: int           # B padded to the 4 x 4 Gram micro-tiles
    slots: int          # 16-byte slots per 4-column chunk (odd)
    mt: int             # micro-tiles per thread (1, 2 or 4)
    smem: int           # dynamic shared memory per block, bytes
    blocks_per_sm: int  # resident blocks per SM the plan is sized for


def _pg_smem_elems(B: int, k: int, tile: int, slots: int,
                   has_bw: bool) -> int:
    """Elements of the kernel's shared layout (PgLayout in quasi_def.cu):
    the ring of staged tiles and the tile's yx."""
    stage = k * (tile // 4) * slots * 4
    ring = 2 * k * tile + tile + (B * tile if has_bw else 0)
    return (_PG_STAGES + 1) * stage + _PG_STAGES * ring


def phi_gram_plan(B: int, k: int, itemsize: int,
                  has_bw: bool = True) -> PhiGramPlan:
    """Tile and shared memory of the fused factor kernel: a ring of
    `_PG_STAGES` tiles of bx, dinv, vals, cwinv (and bw), plus the tile's
    yx.  Two blocks per SM where a tile of at least 8 columns fits in half
    an SM, else one block with the widest tile that fits."""
    bpad = -(-B // 4) * 4
    nmt = (bpad // 4) ** 2
    mt = next((m for m in (1, 2, 4) if nmt <= _PG_THREADS * m), None)
    _require(mt is not None,
             f"stack too tall for the Gram micro-tiles (B={B}, k={k})")
    slots = (bpad + bpad // 4) | 1
    red = _PG_THREADS * mt * 16
    for per_sm, tiles in ((2, (32, 16, 8)), (1, (64, 32, 16, 8, 4))):
        if per_sm > 1 and mt > 1:
            continue
        budget = min(_SM_SMEM_BYTES // per_sm - 1024, _BLOCK_SMEM_BYTES)
        for tile in tiles:
            smem = max(_pg_smem_elems(B, k, tile, slots, has_bw),
                       red) * itemsize
            if smem <= budget:
                return PhiGramPlan(tile, bpad, slots, mt, smem, per_sm)
    raise ValueError(f"stack too tall for the shared stage (B={B}, k={k})")


def phi_gram_tile(B: int, k: int, itemsize: int) -> int:
    """Columns per shared-memory tile of the fused factor kernel."""
    return phi_gram_plan(B, k, itemsize).tile


def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def phi_gram(dinv2, cwinv, vals_t, bx3, bw2=None, bx3_tail=None):
    """Quasi-definite solve of the [B, k, nwcon] stack [bx3; bx3_tail] plus
    the [B, B] Gram matrix gram[a, b] = bx_a · yx_b in one sweep (replaces
    `phi_gram_blocked_t`, pallas_kernels.py:210-255).  The stack is read as
    two row blocks (the factor setup's Z_qn rows, then A's), so the caller
    need not concatenate them; bw2 None means zero.
    Returns (yx3 [B, k, nwcon], yw [B, nwcon], gram [B, B])."""
    if _check_qd(dinv2, cwinv, vals_t, bx3, bw2, bx3_tail) == "cpu":
        return phi_gram_plain(dinv2, cwinv, vals_t, bx3, bw2, bx3_tail)
    Btop, k, W = bx3.shape
    B = Btop + (0 if bx3_tail is None else bx3_tail.shape[0])
    plan = phi_gram_plan(B, k, bx3.element_size(), bw2 is not None)
    ntiles = -(-W // plan.tile)
    nblocks = max(1, min(ntiles,
                         plan.blocks_per_sm * _sm_count(bx3.device)))
    kw = dict(dtype=bx3.dtype, device=bx3.device)
    yx = torch.empty((B, k, W), **kw)
    yw = torch.empty((B, W), **kw)
    partials = torch.empty((nblocks, B, B), **kw)
    gram = torch.empty((B, B), **kw)
    vec = W % 4 == 0 and _aligned16(dinv2, cwinv, vals_t, bx3, bx3_tail,
                                    bw2, yx, yw)
    fn = getattr(_lib(), f"paropt_phi_gram_{_SUFFIX[bx3.dtype]}")
    _launch("phi_gram", fn, bx3.device,
            *(_ptr(t) for t in (dinv2, cwinv, vals_t, bx3, bx3_tail, bw2, yx,
                                yw, partials, gram)),
            B, Btop, k, W, plan.tile, plan.slots, plan.mt, plan.smem,
            nblocks, int(vec))
    return yx, yw, gram
