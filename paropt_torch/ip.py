"""Merit-function pieces shared by the interior-point solvers and the
``qn_storage_dtype`` mapping (counterparts of the helpers at
paropt_tpu/ip.py:50-56 and :176-193).  The host-loop `InteriorPoint` is not
ported yet."""

from __future__ import annotations

import torch

from .ops import qn as qnmod
from .ops.kkt import ProblemData

__all__ = ["_barrier_terms", "_infeas_l2", "_resolve_qn_storage"]


def _resolve_qn_storage(opt_value: str, compute_dtype):
    """Map the `qn_storage_dtype` option to a qn_init storage dtype."""
    if opt_value == "bfloat16":
        return torch.bfloat16
    if opt_value == "auto":
        return qnmod.default_storage_dtype(compute_dtype)
    return None


def _barrier_terms(x, s, t, sw, tw, d: ProblemData, rel_bound_barrier):
    """Sum of log-barrier terms (the φ part of the merit function,
    `evalMeritFunc`, `ParOptInteriorPoint.cpp:3524-3650`)."""
    total = rel_bound_barrier * (
        torch.sum(torch.where(d.lb_mask > 0,
                              torch.log(torch.clamp(x - d.lb, min=1e-300)),
                              0.0))
        + torch.sum(torch.where(d.ub_mask > 0,
                                torch.log(torch.clamp(d.ub - x, min=1e-300)),
                                0.0)))
    for arr in (s, t, sw, tw):
        if arr.numel():
            total = total + torch.sum(torch.log(torch.clamp(arr, min=1e-300)))
    return total


def _infeas_l2(c, s, t, cw, sw, tw):
    total = torch.zeros((), dtype=s.dtype, device=s.device)
    if c.numel():
        total = total + torch.sum((c - s + t) ** 2)
    if cw.numel():
        total = total + torch.sum((cw - sw + tw) ** 2)
    return torch.sqrt(total)
