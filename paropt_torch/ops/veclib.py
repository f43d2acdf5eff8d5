"""Core vector reductions (counterpart of paropt_tpu/ops/veclib.py).

``mdot`` keeps the reference's latency feature: k dot products as ONE
stacked reduction (`ParOptVec::mdot`, `ParOptVec.cpp:152-170`)."""

from __future__ import annotations

from typing import Sequence

import torch

__all__ = ["dot", "mdot", "matmul", "norm2", "l1norm", "maxabs", "norm",
           "multi_norm", "safe_div"]


def dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """<x, y> over all elements."""
    return torch.sum(x * y)


def mdot(ys: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Batched inner products ``[<ys[i], x>]_i`` for stacked ys [k, n]."""
    return ys @ x


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in the promoted dtype of the two operands (numpy/JAX
    promotion; torch's matmul refuses mixed dtypes, e.g. a bfloat16 QN
    buffer against a float vector)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


def norm2(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(dot(x, x))


def l1norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.abs(x))


def maxabs(x: torch.Tensor) -> torch.Tensor:
    if x.numel() == 0:
        return torch.zeros((), dtype=x.dtype, device=x.device)
    return torch.max(torch.abs(x))


def norm(x: torch.Tensor, norm_type: str) -> torch.Tensor:
    """Norm selected by the ``norm_type`` option ('infinity' | 'l1' | 'l2')."""
    if norm_type == "infinity":
        return maxabs(x)
    if norm_type == "l1":
        return l1norm(x)
    if norm_type == "l2":
        return norm2(x)
    raise ValueError(f"unknown norm_type {norm_type!r}")


def multi_norm(parts: Sequence[torch.Tensor], norm_type: str) -> torch.Tensor:
    """Norm of the concatenation of ``parts`` without materializing it."""
    ref = parts[0]
    parts = [p for p in parts if p.numel() > 0]
    if not parts:
        return torch.zeros((), dtype=ref.dtype, device=ref.device)
    if norm_type == "infinity":
        out = maxabs(parts[0])
        for p in parts[1:]:
            out = torch.maximum(out, maxabs(p))
        return out
    if norm_type == "l1":
        return sum(l1norm(p) for p in parts)
    if norm_type == "l2":
        return torch.sqrt(sum(dot(p, p) for p in parts))
    raise ValueError(f"unknown norm_type {norm_type!r}")


def safe_div(num: torch.Tensor, den: torch.Tensor,
             eps: float = 0.0) -> torch.Tensor:
    """num/den with den guarded away from exact zero (barrier quotients)."""
    if eps:
        pos = torch.full_like(den, eps)
        guard = torch.where(den < 0, -pos, pos)
        den = torch.where(torch.abs(den) < eps, guard, den)
    return num / den
