"""The card's published peaks and the byte and operation counts of the
port's three CUDA kernels, from the shapes of their custom-op calls.

Each call's bytes count every input read once and every output written
once, whatever the kernel reads again (an operand the instances share,
passed as an expanded view with stride 0, once).  The operations are the
float multiply-adds the function needs, two each.  The bound of a call is
the larger of bytes over the memory rate and operations over the float32
rate.
"""

from __future__ import annotations

import math

# one NVIDIA H100 SXM (NVIDIA's data sheet): HBM3 bandwidth and float32
# outside the tensor cores, at the full power limit of 700 W
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12


def _numel(shape) -> int:
    return math.prod(shape) if shape else 1


def _size(shape, itemsize) -> int:
    return _numel(shape) * itemsize


def qn_roll_update(buf, s, y, upd, itemsize=4, acc_itemsize=4):
    """(bytes, operations) of paropt::qn_roll_update: buf [(kb,) 2m, n],
    s and y [(kb,) n], upd [(kb,)]; out like buf, dots [(kb,) 2m, 2] in the
    accumulation dtype."""
    rows = buf[-2]
    lead = _numel(buf[:-2])
    nbytes = (2 * _size(buf, itemsize) + _size(s, itemsize)
              + _size(y, itemsize) + _numel(upd)
              + lead * rows * 2 * acc_itemsize)
    return nbytes, 4 * _numel(buf)


def quasi_def_apply(dinv2, cwinv, vals_t, bx3, bw2, itemsize=4,
                    vals_shared=False):
    """(bytes, operations) of paropt::quasi_def_apply: dinv2, vals_t
    [(kb,) k, W]; cwinv [(kb,) W]; bx3 [(kb,) K, k, W]; bw2 [(kb,) K, W];
    outputs like bx3 and bw2."""
    k, W = dinv2[-2], dinv2[-1]
    K = bx3[-3]
    kb = _numel(bx3[:-3])
    vals = vals_t[-2:] if vals_shared else vals_t
    nbytes = itemsize * (_numel(dinv2) + _numel(cwinv) + _numel(vals)
                         + 2 * _numel(bx3) + 2 * _numel(bw2))
    return nbytes, kb * K * W * (6 * k + 2)


def phi_gram(dinv2, cwinv, vals_t, bx3, bw2=None, bx3_tail=None,
             itemsize=4, vals_shared=False):
    """(bytes, operations) of paropt::phi_gram: the stack [bx3; bx3_tail]
    of B rows [(kb,) B, k, W] solved, and its [B, B] Gram matrix; outputs
    yx [(kb,) B, k, W], yw [(kb,) B, W], gram [(kb,) B, B]."""
    k, W = dinv2[-2], dinv2[-1]
    kb = _numel(bx3[:-3])
    B = bx3[-3] + (bx3_tail[-3] if bx3_tail else 0)
    vals = vals_t[-2:] if vals_shared else vals_t
    stack = kb * B * k * W
    nbytes = itemsize * (_numel(dinv2) + _numel(cwinv) + _numel(vals)
                         + 2 * stack + kb * B * W + kb * B * B
                         + (_numel(bw2) if bw2 else 0))
    return nbytes, kb * (2 * B * B * k * W + B * W * (6 * k + 2))


MODELS = {"paropt::qn_roll_update": qn_roll_update,
          "paropt::quasi_def_apply": quasi_def_apply,
          "paropt::phi_gram": phi_gram}


def bound_s(nbytes: float, flops: float) -> float:
    """The least time the card could take: the larger of the two rates'."""
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S)


def call_bound_s(name: str, dims, itemsize: int) -> float:
    """The bound of one logged call, from its input dims (an absent
    optional input is an empty list) and its item size."""
    if name == "paropt::qn_roll_update":
        # narrow storage accumulates its dots in float32
        nbytes, flops = qn_roll_update(*dims[:4], itemsize=itemsize,
                                       acc_itemsize=max(itemsize, 4))
    elif name == "paropt::quasi_def_apply":
        nbytes, flops = quasi_def_apply(*dims[:5], itemsize=itemsize)
    else:
        args = [d if d else None for d in dims[:6]]
        nbytes, flops = phi_gram(*args, itemsize=itemsize)
    return bound_s(nbytes, flops)
