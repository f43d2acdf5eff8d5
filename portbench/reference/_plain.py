"""What the plain references share: the precisions they compute in, and
the gaps they compare.  numpy and torch only.

A reference computes in float64.  Its control computes the same in TF32,
the precision below float32 with TF32 off that a later change might reach
for: each matrix product's operands rounded to TF32 (10 explicit mantissa
bits, round to nearest even) and the product summed in float32, which is
what cuBLAS does with TF32 allowed, on any device.
"""

from __future__ import annotations

import torch

PRECISIONS = ("float64", "tf32")


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32's mantissa, nearest even."""
    i = t.contiguous().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


class Precision:
    """float64, or TF32 products over float32 arrays."""

    def __init__(self, name: str):
        if name not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}: "
                             f"{name!r}")
        self.name = name
        self.dtype = torch.float64 if name == "float64" else torch.float32

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.name == "tf32":
            a, b = round_tf32(a), round_tf32(b)
        return a @ b


def rel_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / max |want|, in float64."""
    got = got.to(torch.float64).reshape(-1)
    want = want.to(torch.float64).reshape(-1)
    scale = float(torch.max(torch.abs(want)))
    return float(torch.max(torch.abs(got - want))) / max(scale, 1e-300)


def full_precision_products():
    """Turn TF32 off for float32 products, so the emulated TF32 is the only
    rounding below float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
