"""Build the port's state objects from the JAX package's, given as numpy.

Each function takes a dict holding one entry per dataclass field: numpy
arrays for the tensor fields (e.g. ``np.asarray`` of a JAX leaf), plain
Python values for the static fields, and nested dicts for nested states
(``FusedState.vars``, ``FusedState.qn``, ``FusedTRState.qn``).  This lets one
step of each package (an IP step, an MMA or a TR outer iteration) start from
the same mid-trajectory state.  The ``load_*`` functions do the same for
the host-loop solvers: they write a JAX solver's state into a port solver
object of the same configuration.  A batched state (JAX's
``solve_batched`` result, every leaf with a leading k axis) converts whole,
with the same leading axis, and `tree.take(state, i)` is its instance i.
No jax is imported here: a JAX
bfloat16 array arrives as numpy's ``bfloat16`` extension dtype and is
reinterpreted bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .dtypes import resolve_device
from .eig_fused import EigModel, FusedEigTRState
from .ip_fused import FusedState
from .mma import FusedMMAState
from .ops.kkt import IPVars, ProblemData
from .ops.qn import QNState
from .tr import FusedTRState

__all__ = ["to_tensor", "problem_data", "ip_vars", "qn_state", "fused_state",
           "fused_mma_state", "fused_tr_state", "fused_eig_tr_state",
           "load_interior_point",
           "load_trust_region", "load_mma"]

_NESTED = {(FusedState, "vars"): IPVars, (FusedState, "qn"): QNState,
           (FusedTRState, "qn"): QNState, (FusedEigTRState, "qn"): QNState}


def to_tensor(a, device=None) -> torch.Tensor:
    """A copy of a numpy (or numpy-convertible) array as a tensor of the
    same dtype and shape."""
    arr = np.asarray(a)
    device = resolve_device(device)
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


def problem_data(fields: dict, device=None) -> ProblemData:
    """ProblemData from its JAX fields (``Aw_callbacks`` is ignored;
    ``Aw_cols`` becomes int64 for indexing; ``Aw_vals_t`` is derived)."""
    fields = {k: v for k, v in fields.items() if k != "Aw_callbacks"}
    if fields.get("Aw_cols") is not None:
        fields["Aw_cols"] = np.asarray(fields["Aw_cols"]).astype(np.int64)
    return _from_fields(ProblemData, fields, device)


def ip_vars(fields: dict, device=None) -> IPVars:
    return _from_fields(IPVars, fields, device)


def qn_state(fields: dict, device=None) -> QNState:
    return _from_fields(QNState, fields, device)


def fused_state(fields: dict, device=None) -> FusedState:
    """The port's FusedIP state from JAX's `FusedState`, with the GMRES arms
    of a Newton-Krylov step (``gmres_iters``) and the QN state."""
    return _from_fields(FusedState, fields, device)


def fused_mma_state(fields: dict, device=None) -> FusedMMAState:
    """The port's MMA outer-loop state from JAX's `FusedMMAState`."""
    return _from_fields(FusedMMAState, fields, device)


def fused_tr_state(fields: dict, device=None) -> FusedTRState:
    """The port's TR outer-loop state from JAX's `FusedTRState`."""
    return _from_fields(FusedTRState, fields, device)


def fused_eig_tr_state(fields: dict, device=None) -> FusedEigTRState:
    """The port's eigen-TR outer-loop state from JAX's `FusedEigTRState`;
    its ``eig`` entry is a dict of the `EigModel` fields M, Minv and h."""
    eig = EigModel(**{k: to_tensor(a, device)
                      for k, a in fields["eig"].items()})
    state = _from_fields(FusedEigTRState, dict(fields, eig=None), device)
    return dataclasses.replace(state, eig=eig)


def _qn_or_none(fields, device):
    return None if fields is None else qn_state(fields, device)


def load_interior_point(solver, state: dict):
    """Write a JAX `InteriorPoint`'s state into the port's ``solver``:
    ``vars`` (IPVars fields), ``qn`` (QNState fields or None), ``mu`` and
    ``rho_penalty`` (floats), the evaluation cache ``fobj``, ``c``, ``cw``,
    ``g``, ``A`` and the counters ``niter``, ``neval``, ``ngeval``,
    ``nhvec``.  Returns the solver."""
    dev = solver.device
    solver.vars = ip_vars(state["vars"], dev)
    solver.qn = _qn_or_none(state["qn"], dev)
    solver.mu = float(state["mu"])
    solver.rho_penalty = float(state["rho_penalty"])
    for name in ("fobj", "c", "cw", "g", "A"):
        setattr(solver, name, to_tensor(state[name], dev))
    for name in ("niter", "neval", "ngeval", "nhvec"):
        setattr(solver, name, int(state[name]))
    return solver


def load_trust_region(solver, state: dict):
    """Write a JAX `TrustRegion`'s state into the port's ``solver``: ``xk``,
    ``tr_size``, ``penalty_gamma``, ``filter`` (a list of (f, h) pairs),
    ``qn`` (QNState fields or None) and ``iter_count``.  Returns the
    solver."""
    dev = solver.device
    solver.subproblem.xk = to_tensor(state["xk"], dev)
    solver.tr_size = float(state["tr_size"])
    solver.penalty_gamma = np.array(state["penalty_gamma"], dtype=float)
    solver.filter = [(float(f), float(h)) for f, h in state["filter"]]
    solver.qn_holder["state"] = _qn_or_none(state["qn"], dev)
    solver.iter_count = int(state["iter_count"])
    return solver


def load_mma(solver, state: dict):
    """Write a JAX `MMA`'s state into the port's ``solver``: the iterates
    ``x``, ``x1``, ``x2``, the asymptotes ``L``, ``U``, the multipliers
    ``z``, ``zw``, ``zl``, ``zu`` and the counters ``mma_iter``,
    ``subproblem_iter``.  Returns the solver."""
    dev = solver.x.device
    for name in ("x", "x1", "x2", "L", "U", "z", "zw", "zl", "zu"):
        setattr(solver, name, to_tensor(state[name], dev))
    solver.mma_iter = int(state["mma_iter"])
    solver.subproblem_iter = int(state["subproblem_iter"])
    return solver
