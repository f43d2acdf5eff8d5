"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions
(counterpart of paropt_tpu/ops/pallas_kernels.py).

Each of the three Pallas kernels has here:

- a wrapper that checks device, dtype, shape and contiguity, allocates the
  outputs (and the cross-block partial sums) with ``torch.empty`` and
  launches on the current stream.  A CPU tensor goes to the plain version;
  a CUDA tensor launches the kernel or raises — there is no fallback;
- the plain PyTorch version of the same function;
- a launch count in ``LAUNCHES``, raised by one where the wrapper launches
  its kernel and nowhere else;
- an instance-axis form (``*_batched``) for k solves run as one
  (``solve_batched``): every operand carries a leading instance axis (a
  shared operand may be an expanded view, stride 0) and the kernel runs
  the kb instances in ONE launch, counted also in ``BATCHED_LAUNCHES``;
  on the CPU it is the plain version under ``torch.vmap``.

Each wrapper is a ``torch.library.custom_op`` whose vmap rule calls the
instance-axis form, so ``torch.func.vmap`` over a solver step reaches the
kernels with one launch per call whatever the instance count, and no
batched tensor's ``data_ptr`` is ever read.

On a DTensor (state sharded over a device mesh, `parallel.sharding`) each
op's DTensor sharding rule (`_register_sharding`, at the end) runs it on
every rank's local shard: on the card each rank launches the kernel on its
shard, and the plain version never stands in (the JAX package turns its
Pallas kernels off on more than one device).  ``qn_roll_update`` works on
column shards of the ring buffer and all-reduces its [2m, 2] dots.  The
quasi-definite kernels sum over the k rows of the [k, nwcon] view, and a
contiguous shard of x is a band of those rows: the rule moves their
operands to column shards (each rank then owns whole constraints; one
all-to-all of the K·n right-hand sides and of Dinv), launches the
unchanged kernel there, and the wrapper moves yx back to row shards,
gathers yw and all-reduces phi_gram's Gram matrix.  So the mesh size must
divide both k and nwcon (`check_split`).

The kernels live in ``paropt_torch/csrc`` (``qn_roll.cu``,
``quasi_def.cu``) and are built by ``_build.load_library`` on first use.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..parallel.sharding import is_sharded, mesh_size

__all__ = ["LAUNCHES", "BATCHED_LAUNCHES", "reset_launches",
           "qn_roll_update", "qn_roll_update_plain", "qn_roll_update_batched",
           "quasi_def_apply", "quasi_def_apply_plain",
           "quasi_def_apply_batched", "phi_gram", "phi_gram_plain",
           "phi_gram_batched", "phi_gram_plan", "phi_gram_tile",
           "phi_gram_grid", "phi_gram_walk", "check_split"]

# kernel name -> launches since the last reset_launches()
LAUNCHES = {"qn_roll_update": 0, "quasi_def_apply": 0, "phi_gram": 0}
# kernel name -> instance-axis launches (each also counted in LAUNCHES)
BATCHED_LAUNCHES = dict(LAUNCHES)

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
        BATCHED_LAUNCHES[name] = 0


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


def _launch(name: str, fn, device: torch.device, *args,
            batched: bool = False) -> None:
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
    LAUNCHES[name] += 1
    if batched:
        BATCHED_LAUNCHES[name] += 1


def _lib():
    from ._build import load_library
    return load_library()


def _inst(t: torch.Tensor):
    """(tensor, instance stride in elements) of a [kb, ...] operand: an
    operand shared by the instances (an expanded view, or kb = 1) passes
    its first instance with stride 0; one whose every instance is
    contiguous passes as it is with its instance stride (a block of rows
    sliced from a larger stack is not copied); any other is made
    contiguous."""
    if t.shape[0] == 1 or t.stride(0) == 0:
        return t[0].contiguous(), 0
    if not t[0].is_contiguous():
        t = t.contiguous()
    return t, t.stride(0)


def _aligned_inst(*pairs) -> bool:
    """Every instance of every (tensor, stride) operand starts on a
    16-byte boundary."""
    return all(t.data_ptr() % 16 == 0 and (st * t.element_size()) % 16 == 0
               for t, st in pairs if t is not None)


def _vmap_args(info, in_dims, *args):
    """The operands of a vmap rule with the instance axis first (an
    unbatched operand as an expanded view; None stays None)."""
    kb = info.batch_size
    return [None if a is None
            else a.movedim(d, 0) if d is not None
            else a.unsqueeze(0).expand((kb,) + tuple(a.shape))
            for a, d in zip(args, in_dims)]


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


def _per_instance(plain, *ops):
    """A plain version over a leading instance axis: the single plain call
    on each instance, stacked.  (One batched product would reduce in
    another order: cuBLAS's f32 batched product over 2^20 terms was 1e4
    times further from the f64 result than the single product.)"""
    outs = [plain(*(None if o is None else o[i] for o in ops))
            for i in range(ops[0].shape[0])]
    return tuple(torch.stack(parts) for parts in zip(*outs))


def qn_roll_update_plain_batched(buf, s, y, upd):
    """`qn_roll_update_plain` over a leading instance axis: buf
    [kb, 2m, n], s and y [kb, n], upd [kb]."""
    return _per_instance(qn_roll_update_plain, buf, s, y, upd)


def qn_roll_update(buf: torch.Tensor, s: torch.Tensor, y: torch.Tensor,
                   upd: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused roll/select/dots over the stacked [2m, n] S/Y buffer
    (replaces `qn_roll_update`, pallas_kernels.py:68-149).

    ``upd`` is a 0-d bool tensor on the buffer's device; the kernel reads it
    there (no host sync).  The roll is out of place: ``buf`` is unchanged.
    Returns (buf_out [2m, n], dots [2m, 2] in f32 for narrow storage, else
    in the buffer's dtype).  Under ``torch.func.vmap`` one call launches
    the instance-axis kernel once (`qn_roll_update_batched`)."""
    _require(buf.dim() == 2 and buf.shape[0] % 2 == 0 and buf.shape[0] >= 2,
             f"buf must be [2m, n], got {tuple(buf.shape)}")
    rows, n = buf.shape
    _require(s.shape == (n,) and y.shape == (n,),
             "s and y must be [n] matching buf")
    _require(upd.dim() == 0 and upd.dtype == torch.bool,
             "upd must be a 0-d bool tensor")
    _route(buf, s, y, upd)
    out, dots = _qn_roll_op(buf, s, y, upd)
    return out, _placed_like(dots, None)


@torch.library.custom_op(
    "paropt::qn_roll_update", mutates_args=(),
    schema="(Tensor buf, Tensor s, Tensor y, Tensor upd) -> (Tensor, Tensor)")
def _qn_roll_op(buf, s, y, upd):
    rows, n = buf.shape
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


@_qn_roll_op.register_fake
def _qn_roll_fake(buf, s, y, upd):
    return (torch.empty_like(buf),
            buf.new_empty((buf.shape[0], 2), dtype=_acc_dtype(buf.dtype)))


@_qn_roll_op.register_vmap
def _qn_roll_vmap(info, in_dims, buf, s, y, upd):
    return qn_roll_update_batched(*_vmap_args(info, in_dims, buf, s, y,
                                              upd)), (0, 0)


def qn_roll_update_batched(buf, s, y, upd):
    """`qn_roll_update` for kb instances in one launch: buf [kb, 2m, n],
    s and y [kb, n], upd [kb] bool (any operand may be an expanded view,
    shared by the instances).  Returns (buf_out [kb, 2m, n], dots
    [kb, 2m, 2]); instance i equals a single call on instance i's operands
    bit for bit."""
    _require(buf.dim() == 3 and buf.shape[1] % 2 == 0 and buf.shape[1] >= 2,
             f"buf must be [kb, 2m, n], got {tuple(buf.shape)}")
    kb, rows, n = buf.shape
    _require(s.shape == (kb, n) and y.shape == (kb, n),
             "s and y must be [kb, n] matching buf")
    _require(upd.shape == (kb,) and upd.dtype == torch.bool,
             "upd must be a [kb] bool tensor")
    if _route(buf, s, y, upd) == "cpu":
        return qn_roll_update_plain_batched(buf, s, y, upd)
    _require(buf.dtype in _SUFFIX, f"unsupported buffer dtype {buf.dtype}")
    (bb, sb), (sq, ss), (yq, sy), (ub, su) = (
        _inst(t) for t in (buf, s.to(buf.dtype), y.to(buf.dtype), upd))
    lib = _lib()
    acc = _acc_dtype(buf.dtype)
    nblocks = max(1, -(-n // lib.paropt_qn_roll_tile()))
    out = torch.empty((kb, rows, n), dtype=buf.dtype, device=buf.device)
    partials = torch.empty((kb, nblocks, rows, 2), dtype=acc,
                           device=buf.device)
    dots = torch.empty((kb, rows, 2), dtype=acc, device=buf.device)
    fn = getattr(lib, f"paropt_qn_roll_update_batched_{_SUFFIX[buf.dtype]}")
    _launch("qn_roll_update", fn, buf.device,
            *(t.data_ptr() for t in (bb, sq, yq, ub, out, partials, dots)),
            rows // 2, n, nblocks, kb, sb, ss, sy, su, batched=True)
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


def quasi_def_apply_plain_batched(dinv2, cwinv, vals_t, bx3, bw2=None):
    """`quasi_def_apply_plain` over a leading instance axis of every
    operand."""
    return _per_instance(quasi_def_apply_plain, dinv2, cwinv, vals_t, bx3,
                         bw2)


def phi_gram_plain_batched(dinv2, cwinv, vals_t, bx3, bw2=None,
                           bx3_tail=None):
    """`phi_gram_plain` over a leading instance axis of every operand."""
    return _per_instance(phi_gram_plain, dinv2, cwinv, vals_t, bx3, bw2,
                         bx3_tail)


def phi_gram_plain(dinv2, cwinv, vals_t, bx3, bw2=None, bx3_tail=None):
    """The quasi-definite apply of the stack [bx3; bx3_tail] plus
    gram[a, b] = bx_a · yx_b."""
    if bx3_tail is not None:
        bx3 = torch.cat([bx3, bx3_tail])
    yx, yw = quasi_def_apply_plain(dinv2, cwinv, vals_t, bx3, bw2)
    B = bx3.shape[0]
    gram = bx3.reshape(B, -1) @ yx.reshape(B, -1).T
    return yx, yw, gram


def _check_shapes(dinv2, cwinv, vals_t, bx3, bw2, bx3_tail=None) -> str:
    """The operands' shapes and dtypes; returns the route ('cpu' or
    'cuda').  Reads no pointer, so it runs on batched tensors too."""
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
    return route


def _check_qd(dinv2, cwinv, vals_t, bx3, bw2, bx3_tail=None) -> str:
    route = _check_shapes(dinv2, cwinv, vals_t, bx3, bw2, bx3_tail)
    if route == "cuda":
        _require(all(t.is_contiguous() for t in
                     (dinv2, cwinv, vals_t, bx3, bw2, bx3_tail)
                     if t is not None),
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
    [nwcon]; bx3 [K, k, nwcon]; bw2 [K, nwcon].  Returns (yx3, yw2).  Under
    ``torch.func.vmap`` one call launches the instance-axis kernel once
    (`quasi_def_apply_batched`)."""
    _require(bw2 is not None, "bw must be [K, nwcon]")
    _check_shapes(dinv2, cwinv, vals_t, bx3, bw2)
    check_split(bx3, *dinv2.shape)
    yx, yw = _quasi_def_op(dinv2, cwinv, vals_t, bx3, bw2)
    return _placed_like(yx, bx3), _placed_like(yw, None)


@torch.library.custom_op(
    "paropt::quasi_def_apply", mutates_args=(),
    schema="(Tensor dinv2, Tensor cwinv, Tensor vals_t, Tensor bx3, "
           "Tensor bw2) -> (Tensor, Tensor)")
def _quasi_def_op(dinv2, cwinv, vals_t, bx3, bw2):
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


@_quasi_def_op.register_fake
def _quasi_def_fake(dinv2, cwinv, vals_t, bx3, bw2):
    return torch.empty_like(bx3), torch.empty_like(bw2)


@_quasi_def_op.register_vmap
def _quasi_def_vmap(info, in_dims, *args):
    return quasi_def_apply_batched(*_vmap_args(info, in_dims, *args)), (0, 0)


def _check_batched(dinv2, cwinv, vals_t, bx3, bw2, bx3_tail=None) -> str:
    """The checks of `_check_shapes` on [kb, ...] operands (the instance
    axis leading every one)."""
    _require(bx3.dim() == 4, "bx must be [kb, K, k, nwcon]")
    kb = bx3.shape[0]
    ops = [t for t in (dinv2, cwinv, vals_t, bx3, bw2, bx3_tail)
           if t is not None]
    _require(all(t.shape[0] == kb for t in ops),
             "every operand needs the same leading instance axis")
    return _check_shapes(dinv2[0], cwinv[0], vals_t[0], bx3[0],
                         None if bw2 is None else bw2[0],
                         None if bx3_tail is None else bx3_tail[0])


def quasi_def_apply_batched(dinv2, cwinv, vals_t, bx3, bw2):
    """`quasi_def_apply` for kb instances in one launch: dinv2, vals_t
    [kb, k, nwcon]; cwinv [kb, nwcon]; bx3 [kb, K, k, nwcon]; bw2
    [kb, K, nwcon].  An operand the instances share (vals_t, unless a
    sweep changes it) may be an expanded view: the kernel reads it with
    stride 0.  Instance i equals a single call bit for bit."""
    _require(bw2 is not None, "bw must be [kb, K, nwcon]")
    if _check_batched(dinv2, cwinv, vals_t, bx3, bw2) == "cpu":
        return quasi_def_apply_plain_batched(dinv2, cwinv, vals_t, bx3, bw2)
    kb, K, k, W = bx3.shape
    pairs = [_inst(t) for t in (dinv2, cwinv, vals_t, bx3, bw2)]
    yx = torch.empty((kb, K, k, W), dtype=bx3.dtype, device=bx3.device)
    yw = torch.empty((kb, K, W), dtype=bx3.dtype, device=bx3.device)
    vec = (W % (16 // bx3.element_size()) == 0
           and _aligned_inst(*pairs, (yx, K * k * W), (yw, K * W)))
    fn = getattr(_lib(), f"paropt_quasi_def_apply_batched_"
                         f"{_SUFFIX[bx3.dtype]}")
    _launch("quasi_def_apply", fn, bx3.device,
            *(t.data_ptr() for t, _ in pairs), yx.data_ptr(), yw.data_ptr(),
            K, k, W, int(vec), kb, *(st for _, st in pairs), batched=True)
    return yx, yw


class PhiGramPlan(NamedTuple):
    """How `phi_gram` lays a [B, k, nwcon] stack out on the card."""
    tile: int           # columns per tile (a multiple of 4)
    bpad: int           # B padded to the 4 x 4 Gram micro-tiles
    slots: int          # 16-byte slots per 4-column chunk (odd)
    mt: int             # micro-tiles per thread (1, 2 or 4)
    smem: int           # dynamic shared memory per block, bytes
    blocks_per_sm: int  # resident blocks per SM the plan is sized for


def _pg_mt(bpad: int):
    """Gram micro-tiles per thread for B padded to ``bpad`` (None: too
    many)."""
    nmt = (bpad // 4) ** 2
    return next((m for m in (1, 2, 4) if nmt <= _PG_THREADS * m), None)


def _pg_red_elems(bpad: int, mt: int) -> int:
    """Elements of the Gram reduction (pg_red_elems in quasi_def.cu): the
    micro-tiles of the threads that share each micro-tile."""
    nmt = (bpad // 4) ** 2
    return (_PG_THREADS // nmt if mt == 1 else 1) * nmt * 16


def _pg_smem_elems(B: int, k: int, tile: int, slots: int,
                   has_bw: bool) -> int:
    """Elements of the kernel's shared layout (PgLayout in quasi_def.cu):
    the ring of staged tiles and the tile's yx, and the Gram reduction
    where it does not fit in the two regions a virtual block's end frees
    (a stage and the tile's yx)."""
    stage = k * (tile // 4) * slots * 4
    ring = 2 * k * tile + tile + (B * tile if has_bw else 0)
    bpad = -(-B // 4) * 4
    red = _pg_red_elems(bpad, _pg_mt(bpad))
    return ((_PG_STAGES + 1) * stage + _PG_STAGES * ring
            + (red if red > 2 * stage else 0))


def phi_gram_plan(B: int, k: int, itemsize: int,
                  has_bw: bool = True) -> PhiGramPlan:
    """Tile and shared memory of the fused factor kernel: a ring of
    `_PG_STAGES` tiles of bx, dinv, vals, cwinv (and bw), plus the tile's
    yx.  Two blocks per SM where a tile of at least 8 columns fits in half
    an SM, else one block with the widest tile that fits."""
    bpad = -(-B // 4) * 4
    mt = _pg_mt(bpad)
    _require(mt is not None,
             f"stack too tall for the Gram micro-tiles (B={B}, k={k})")
    slots = (bpad + bpad // 4) | 1
    for per_sm, tiles in ((2, (32, 16, 8)), (1, (64, 32, 16, 8, 4))):
        if per_sm > 1 and mt > 1:
            continue
        budget = min(_SM_SMEM_BYTES // per_sm - 1024, _BLOCK_SMEM_BYTES)
        for tile in tiles:
            smem = _pg_smem_elems(B, k, tile, slots, has_bw) * itemsize
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
    Returns (yx3 [B, k, nwcon], yw [B, nwcon], gram [B, B]).  Under
    ``torch.func.vmap`` one call launches the instance-axis kernel once
    (`phi_gram_batched`)."""
    _check_shapes(dinv2, cwinv, vals_t, bx3, bw2, bx3_tail)
    check_split(bx3, *dinv2.shape)
    yx, yw, gram = _phi_gram_op(dinv2, cwinv, vals_t, bx3, bw2, bx3_tail)
    return (_placed_like(yx, bx3), _placed_like(yw, None),
            _placed_like(gram, None))


@torch.library.custom_op(
    "paropt::phi_gram", mutates_args=(),
    schema="(Tensor dinv2, Tensor cwinv, Tensor vals_t, Tensor bx3, "
           "Tensor? bw2, Tensor? bx3_tail) -> (Tensor, Tensor, Tensor)")
def _phi_gram_op(dinv2, cwinv, vals_t, bx3, bw2, bx3_tail):
    if _check_qd(dinv2, cwinv, vals_t, bx3, bw2, bx3_tail) == "cpu":
        return phi_gram_plain(dinv2, cwinv, vals_t, bx3, bw2, bx3_tail)
    Btop, k, W = bx3.shape
    B = Btop + (0 if bx3_tail is None else bx3_tail.shape[0])
    plan = phi_gram_plan(B, k, bx3.element_size(), bw2 is not None)
    nb, _ = phi_gram_grid(plan, W, _sm_count(bx3.device))
    kw = dict(dtype=bx3.dtype, device=bx3.device)
    yx = torch.empty((B, k, W), **kw)
    yw = torch.empty((B, W), **kw)
    partials = torch.empty((nb, B, B), **kw)
    gram = torch.empty((B, B), **kw)
    vec = W % 4 == 0 and _aligned16(dinv2, cwinv, vals_t, bx3, bx3_tail,
                                    bw2, yx, yw)
    fn = getattr(_lib(), f"paropt_phi_gram_{_SUFFIX[bx3.dtype]}")
    _launch("phi_gram", fn, bx3.device,
            *(_ptr(t) for t in (dinv2, cwinv, vals_t, bx3, bx3_tail, bw2, yx,
                                yw, partials, gram)),
            B, Btop, k, W, plan.tile, plan.slots, plan.mt, plan.smem, nb,
            int(vec))
    return yx, yw, gram


@_phi_gram_op.register_fake
def _phi_gram_fake(dinv2, cwinv, vals_t, bx3, bw2, bx3_tail):
    k, W = dinv2.shape
    B = bx3.shape[0] + (0 if bx3_tail is None else bx3_tail.shape[0])
    return (bx3.new_empty((B, k, W)), bx3.new_empty((B, W)),
            bx3.new_empty((B, B)))


@_phi_gram_op.register_vmap
def _phi_gram_vmap(info, in_dims, *args):
    return phi_gram_batched(*_vmap_args(info, in_dims, *args)), (0, 0, 0)


def phi_gram_grid(plan: PhiGramPlan, W: int, sms: int,
                  kb: int = 1) -> Tuple[int, int]:
    """(nb, grid) of a launch over kb instances on a card of ``sms`` SMs:
    nb virtual blocks per instance, the single launch's persistent grid
    (a block per tile, at most blocks_per_sm × SMs), and the grid of
    min(kb·nb, blocks_per_sm × SMs) physical blocks that walks the kb·nb
    virtual blocks (`phi_gram_walk`).  Each instance keeps the single
    launch's plan, blocks and tile walk, so every sum is the single
    launch's; kb = 1 is the single launch."""
    resident = plan.blocks_per_sm * sms
    nb = max(1, min(-(-W // plan.tile), resident))
    return nb, min(kb * nb, resident)


def phi_gram_walk(nb: int, grid: int, kb: int, ntiles: int, g: int):
    """What physical block g of `phi_gram_grid`'s launch works on, in
    order: [(instance, block, [tiles])], the walk of `phi_gram_kernel`
    (quasi_def.cu).  It takes virtual blocks v = g, g + grid, ... < kb·nb;
    v is block b = (v % nb + i·(ntiles % nb)) % nb of instance i = v // nb
    (the rotation spreads the blocks that hold one tile more), and takes
    the single launch's tiles of block b: b, b + nb, ... < ntiles."""
    walk = []
    for v in range(g, kb * nb, grid):
        i = v // nb
        b = (v % nb + i * (ntiles % nb)) % nb
        walk.append((i, b, list(range(b, ntiles, nb))))
    return walk


def phi_gram_batched(dinv2, cwinv, vals_t, bx3, bw2=None, bx3_tail=None):
    """`phi_gram` for kb instances in one launch: every operand of
    `phi_gram` with a leading instance axis (dinv2, vals_t [kb, k, nwcon];
    cwinv [kb, nwcon]; bx3 [kb, Btop, k, nwcon]; bx3_tail [kb, B2, k,
    nwcon] or None; bw2 [kb, B, nwcon] or None), shared operands as
    expanded views.  Returns (yx3 [kb, B, k, nwcon], yw [kb, B, nwcon],
    gram [kb, B, B]); instance i equals a single call bit for bit.  One
    persistent grid walks the kb instances' virtual blocks
    (`phi_gram_grid`)."""
    if _check_batched(dinv2, cwinv, vals_t, bx3, bw2, bx3_tail) == "cpu":
        return phi_gram_plain_batched(dinv2, cwinv, vals_t, bx3, bw2,
                                      bx3_tail)
    kb, Btop, k, W = bx3.shape
    B = Btop + (0 if bx3_tail is None else bx3_tail.shape[1])
    plan = phi_gram_plan(B, k, bx3.element_size(), bw2 is not None)
    nb, grid = phi_gram_grid(plan, W, _sm_count(bx3.device), kb)
    kw = dict(dtype=bx3.dtype, device=bx3.device)
    yx = torch.empty((kb, B, k, W), **kw)
    yw = torch.empty((kb, B, W), **kw)
    partials = torch.empty((kb, nb, B, B), **kw)
    gram = torch.empty((kb, B, B), **kw)
    pairs = [(None, 0) if t is None else _inst(t)
             for t in (dinv2, cwinv, vals_t, bx3, bx3_tail, bw2)]
    vec = W % 4 == 0 and _aligned_inst(*pairs, (yx, B * k * W), (yw, B * W))
    fn = getattr(_lib(), f"paropt_phi_gram_batched_{_SUFFIX[bx3.dtype]}")
    _launch("phi_gram", fn, bx3.device,
            *(_ptr(t) for t, _ in pairs),
            *(t.data_ptr() for t in (yx, yw, partials, gram)),
            B, Btop, k, W, plan.tile, plan.slots, plan.mt, plan.smem, nb,
            grid, int(vec), kb, *(st for _, st in pairs), batched=True)
    return yx, yw, gram


# ---------------------------------------------------------------------------
# DTensor sharding rules (state sharded over a device mesh)
# ---------------------------------------------------------------------------


def check_split(bx3, k: int, W: int) -> None:
    """Raise ValueError unless the mesh of a sharded operand divides both k
    and nwcon: the quasi-definite kernels need whole rows of the [k, nwcon]
    view on each rank (a contiguous shard of x) and then whole columns
    (the column shards the kernel runs on)."""
    P = mesh_size(bx3)
    if k % P or W % P:
        raise ValueError(
            f"a mesh of {P} ranks cannot split the blocked_t view [k={k}, "
            f"nwcon={W}]: the rank count must divide k and nwcon")


def _placed_like(t, ref):
    """An op's output moved to ``ref``'s placements (replicated when
    ``ref`` is None or a plain tensor); a plain ``t`` passes as it is."""
    if not is_sharded(t):
        return t
    from torch.distributed.tensor import Replicate
    want = (ref.placements if is_sharded(ref)
            else [Replicate()] * t.device_mesh.ndim)
    return t.redistribute(t.device_mesh, want)


def _register_sharding() -> None:
    """The three ops' DTensor rules: each rank runs the op (the kernel on
    the card) on its local shard.  One placement per mesh axis; a 2-D mesh
    takes the same placement on both axes."""
    if not torch.distributed.is_available():
        return
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding
    R = Replicate()

    @register_sharding(torch.ops.paropt.qn_roll_update.default)
    def _qn_roll_rule(buf, s, y, upd):
        # columns of the ring buffer with the matching entries of s and y;
        # the dots are partial sums over each rank's columns
        return [([Shard(1), Partial()], [Shard(1), Shard(0), Shard(0), R])]

    @register_sharding(torch.ops.paropt.quasi_def_apply.default)
    def _quasi_def_rule(dinv2, cwinv, vals_t, bx3, bw2):
        # whole constraints (columns of the [k, nwcon] view) on each rank
        return [([Shard(2), Shard(1)],
                 [Shard(1), Shard(0), Shard(1), Shard(2), Shard(1)])]

    @register_sharding(torch.ops.paropt.phi_gram.default)
    def _phi_gram_rule(dinv2, cwinv, vals_t, bx3, bw2, bx3_tail):
        return [([Shard(2), Shard(1), Partial()],
                 [Shard(1), Shard(0), Shard(1), Shard(2),
                  None if bw2 is None else Shard(1),
                  None if bx3_tail is None else Shard(2)])]


_register_sharding()
