"""Default floating dtype and device resolution (counterpart of
paropt_tpu/dtypes.py).

The reference is double precision everywhere, and so is the port's default.
A run in float32 (the card's fast path) asks for it explicitly.  The port
runs on the CUDA card unless the caller asks for the CPU: a constructor
given no device aims at ``cuda``, and without a card PyTorch's own error is
raised when the first tensor is made."""

from __future__ import annotations

import torch

__all__ = ["default_float", "resolve_dtype", "resolve_device"]


def default_float() -> torch.dtype:
    """torch.float64, the reference's precision."""
    return torch.float64


def resolve_dtype(dtype) -> torch.dtype:
    """Pass through an explicit dtype; resolve None to the default."""
    if dtype is None:
        return default_float()
    if not isinstance(dtype, torch.dtype):
        raise TypeError(f"expected a torch.dtype, got {dtype!r}")
    return dtype


def resolve_device(device) -> torch.device:
    """Pass through an explicit device; resolve None to the CUDA card."""
    return torch.device("cuda" if device is None else device)
