"""Checkpoint and resume of solver states (counterpart of
paropt_tpu/utils/checkpoint.py, which writes Orbax checkpoints).

The reference writes binary checkpoints of the full primal-dual state
(`writeSolutionFile` / `readSolutionFile`, `ParOptInteriorPoint.cpp:
883-1110`).  The fused solvers here checkpoint their whole state, the
quasi-Newton ring buffers and every solver scalar included, as the JAX
package does.

The file is one ``torch.save`` of a plain dict: each tensor leaf under its
field path ("vars.x", "qn.buf", "eig.M"), each static field's value, and
the qualified class name of every node, so ``torch.load(...,
weights_only=True)`` reads it without unpickling a class.  `restore_state`
rebuilds the state on the structure of a template: each leaf takes the
template leaf's dtype (bfloat16 QN storage stays bfloat16) and device, and
a class, shape or static-field mismatch raises.  A JAX Orbax checkpoint is
read by paropt_tpu and carried over by `paropt_torch.convert`.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict

import torch

__all__ = ["save_state", "restore_state"]

_FORMAT = "paropt_torch.checkpoint/1"


def _qualname(obj) -> str:
    cls = type(obj)
    return f"{cls.__module__}.{cls.__qualname__}"


def _children(obj):
    """(name, value, static) of a node's fields, or None for a leaf."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return [(f.name, getattr(obj, f.name), f.metadata.get("static",
                                                              False))
                for f in dataclasses.fields(obj)]
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return [(n, getattr(obj, n), False) for n in obj._fields]
    if isinstance(obj, dict):
        return [(str(k), v, False) for k, v in obj.items()]
    return None


def _flatten(obj, path: str, out: Dict[str, Dict[str, Any]]) -> None:
    kids = _children(obj)
    if kids is not None:
        out["classes"][path] = _qualname(obj)
        for name, value, static in kids:
            sub = f"{path}.{name}" if path else name
            if static:
                out["static"][sub] = value
            else:
                _flatten(value, sub, out)
    elif isinstance(obj, torch.Tensor):
        out["tensors"][path] = obj.detach().cpu().clone()
    else:                               # None or a Python scalar
        out["static"][path] = obj


def save_state(path: str, state: Any) -> None:
    """Write a state (a dataclass of tensors such as `FusedState`, a
    NamedTuple or a dict of them) to ``path`` with ``torch.save``."""
    out = {"format": _FORMAT, "class": _qualname(state), "classes": {},
           "tensors": {}, "static": {}}
    _flatten(state, "", out)
    path = os.path.abspath(path)
    tmp = path + ".tmp"
    torch.save(out, tmp)
    os.replace(tmp, path)               # a reader never sees half a file


def _rebuild(tmpl, path: str, saved) -> Any:
    kids = _children(tmpl)
    if kids is not None:
        got = saved["classes"].get(path)
        if got != _qualname(tmpl):
            raise ValueError(f"checkpoint node {path or '<root>'!r} is a "
                             f"{got}, the template a {_qualname(tmpl)}")
        vals = {}
        for name, value, static in kids:
            sub = f"{path}.{name}" if path else name
            if static:
                if saved["static"].get(sub) != value:
                    raise ValueError(
                        f"checkpoint static field {sub!r} is "
                        f"{saved['static'].get(sub)!r}, the template's "
                        f"{value!r}")
                vals[name] = value
            else:
                vals[name] = _rebuild(value, sub, saved)
        if isinstance(tmpl, dict):
            return {k: vals[str(k)] for k in tmpl}
        if isinstance(tmpl, tuple):
            return type(tmpl)(**vals)
        return dataclasses.replace(tmpl, **vals)
    if isinstance(tmpl, torch.Tensor):
        t = saved["tensors"].get(path)
        if t is None:
            raise ValueError(f"checkpoint has no tensor {path!r}")
        if t.shape != tmpl.shape:
            raise ValueError(f"checkpoint tensor {path!r} has shape "
                             f"{tuple(t.shape)}, the template "
                             f"{tuple(tmpl.shape)}")
        return t.to(dtype=tmpl.dtype, device=tmpl.device)
    if path not in saved["static"] or saved["static"][path] != tmpl:
        raise ValueError(f"checkpoint leaf {path!r} is "
                         f"{saved['static'].get(path)!r}, the template's "
                         f"{tmpl!r}")
    return tmpl


def restore_state(path: str, template: Any) -> Any:
    """Read a state written by `save_state`; each tensor leaf takes the
    dtype and device of the template's leaf at the same path."""
    saved = torch.load(os.path.abspath(path), map_location="cpu",
                       weights_only=True)
    if not isinstance(saved, dict) or saved.get("format") != _FORMAT:
        raise ValueError(f"{path} is not a paropt_torch checkpoint")
    if saved["class"] != _qualname(template):
        raise ValueError(f"checkpoint holds a {saved['class']}, the "
                         f"template is a {_qualname(template)}")
    return _rebuild(template, "", saved)
