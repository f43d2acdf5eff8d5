"""Build the port's state objects from the JAX package's, given as numpy.

Each function takes a dict holding one entry per dataclass field: numpy
arrays for the tensor fields (e.g. ``np.asarray`` of a JAX leaf), plain
Python values for the static fields, and nested dicts for nested states
(``FusedState.vars``, ``FusedState.qn``).  This lets one step of each package
start from the same mid-trajectory state.  No jax is imported here: a JAX
bfloat16 array arrives as numpy's ``bfloat16`` extension dtype and is
reinterpreted bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .ip_fused import FusedState
from .ops.kkt import IPVars, ProblemData
from .ops.qn import QNState

__all__ = ["to_tensor", "problem_data", "ip_vars", "qn_state", "fused_state"]

_NESTED = {(FusedState, "vars"): IPVars, (FusedState, "qn"): QNState}


def to_tensor(a, device="cpu") -> torch.Tensor:
    """A copy of a numpy (or numpy-convertible) array as a tensor of the
    same dtype and shape."""
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        bits = np.array(arr, order="C").view(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr, order="C")).to(device)


def _from_fields(cls, fields: dict, device):
    out = {}
    for f in dataclasses.fields(cls):
        if f.name not in fields:
            continue  # a field with a default the caller left out
        val = fields[f.name]
        if f.metadata.get("static") or val is None:
            out[f.name] = val
        elif (cls, f.name) in _NESTED:
            out[f.name] = _from_fields(_NESTED[(cls, f.name)], val, device)
        else:
            out[f.name] = to_tensor(val, device)
    return cls(**out)


def problem_data(fields: dict, device="cpu") -> ProblemData:
    """ProblemData from its JAX fields (``Aw_callbacks`` is ignored;
    ``Aw_cols`` becomes int64 for indexing; ``Aw_vals_t`` is derived)."""
    fields = {k: v for k, v in fields.items() if k != "Aw_callbacks"}
    if fields.get("Aw_cols") is not None:
        fields["Aw_cols"] = np.asarray(fields["Aw_cols"]).astype(np.int64)
    return _from_fields(ProblemData, fields, device)


def ip_vars(fields: dict, device="cpu") -> IPVars:
    return _from_fields(IPVars, fields, device)


def qn_state(fields: dict, device="cpu") -> QNState:
    return _from_fields(QNState, fields, device)


def fused_state(fields: dict, device="cpu") -> FusedState:
    return _from_fields(FusedState, fields, device)
