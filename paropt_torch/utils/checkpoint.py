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

A state sharded over a device mesh (DTensor leaves, `parallel.sharding`)
is written as a ``torch.distributed.checkpoint`` directory (a
``FileSystemWriter``: each rank writes its own shards, every rank calls)
holding the tensors, beside the same dict without them in ``_META``
(``torch.save``, read back with ``weights_only=True``).  DCP reads its own
``.metadata`` file with ``pickle``, so `restore_state` first reads that
file through an unpickler that admits only the globals such a file names
(`_DCPMetadataUnpickler`): loading a directory runs no code it carries,
as loading the single file runs none.  Each leaf comes back placed as the
template's leaf is.  This stands where the JAX package writes an
Orbax/TensorStore directory: the formats differ (ROADMAP queue 3).
"""

from __future__ import annotations

import dataclasses
import enum
import os
import pathlib
import pickle
from typing import Any, Dict

import torch

from ..parallel.sharding import is_sharded, settle, tree_is_sharded

__all__ = ["save_state", "restore_state"]

_FORMAT = "paropt_torch.checkpoint/1"
# a sharded checkpoint directory's non-tensor part
_META = "paropt_state.pt"


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


def _flatten(obj, path: str, out: Dict[str, Dict[str, Any]],
             keep: bool = False) -> None:
    """Fill ``out`` from the tree; ``keep`` leaves each tensor where it is
    (a DTensor stays sharded) instead of copying it to the host."""
    kids = _children(obj)
    if kids is not None:
        out["classes"][path] = _qualname(obj)
        for name, value, static in kids:
            sub = f"{path}.{name}" if path else name
            if static:
                out["static"][sub] = value
            else:
                _flatten(value, sub, out, keep)
    elif isinstance(obj, torch.Tensor):
        out["tensors"][path] = (obj.detach() if keep
                                else obj.detach().cpu().clone())
    else:                               # None or a Python scalar
        out["static"][path] = obj


def save_state(path: str, state: Any) -> None:
    """Write a state (a dataclass of tensors such as `FusedState`, a
    NamedTuple or a dict of them) to ``path`` with ``torch.save``, or, when
    some leaf is a DTensor, to the directory ``path`` with
    ``torch.distributed.checkpoint`` (every rank calls)."""
    out = {"format": _FORMAT, "class": _qualname(state), "classes": {},
           "tensors": {}, "static": {}}
    sharded = tree_is_sharded(state)
    if sharded:
        state = settle(state)   # DCP takes no pending sums
    _flatten(state, "", out, keep=sharded)
    path = os.path.abspath(path)
    if sharded:
        import torch.distributed.checkpoint as dcp
        tensors = out.pop("tensors")
        if torch.distributed.get_rank() == 0:
            os.makedirs(path, exist_ok=True)
            _save_file(out, os.path.join(path, _META))
        dcp.save({"tensors": tensors},
                 storage_writer=dcp.FileSystemWriter(path))
        return
    _save_file(out, path)


def _save_file(obj, path: str) -> None:
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)               # a reader never sees half a file


class _DCPMetadataUnpickler(pickle.Unpickler):
    """Reads DCP's ``.metadata`` pickle, admitting only what such a file
    names: DCP's metadata dataclasses and enums, ``torch.Size``, dtypes,
    layouts and paths.  Any other global (a callable a crafted file would
    have pickle call) raises before its module is imported."""

    _MODULES = ("torch.distributed.checkpoint.metadata",
                "torch.distributed.checkpoint.filesystem", "torch",
                "torch.serialization", "pathlib")

    def find_class(self, module, name):
        if module in self._MODULES or module.startswith("pathlib."):
            obj = super().find_class(module, name)
            if (module.startswith("torch.distributed.checkpoint.")
                    and isinstance(obj, type)
                    and (dataclasses.is_dataclass(obj)
                         or issubclass(obj, enum.Enum))
                    or obj is torch.Size or isinstance(obj, torch.dtype)
                    or (module, name) == ("torch.serialization",
                                          "_get_layout")
                    or isinstance(obj, type)
                    and issubclass(obj, pathlib.PurePath)):
                return obj
        raise pickle.UnpicklingError(
            f"checkpoint metadata names {module}.{name}, which a "
            f"checkpoint does not hold")


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
        if is_sharded(t):
            return t
        return t.to(dtype=tmpl.dtype, device=tmpl.device)
    if path not in saved["static"] or saved["static"][path] != tmpl:
        raise ValueError(f"checkpoint leaf {path!r} is "
                         f"{saved['static'].get(path)!r}, the template's "
                         f"{tmpl!r}")
    return tmpl


def _load_sharded(path: str, template: Any) -> Dict[str, Any]:
    """The dict of a `save_state` directory, each tensor read into an
    empty copy of the template's leaf (its dtype, device and placements)."""
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint.metadata import TensorStorageMetadata
    want = {"tensors": {}, "static": {}, "classes": {}}
    _flatten(template, "", want, keep=True)
    with open(os.path.join(path, ".metadata"), "rb") as f:
        meta = _DCPMetadataUnpickler(f).load().state_dict_metadata
    for key, t in want["tensors"].items():
        got = meta.get(f"tensors.{key}")
        # a bytes item would be unpickled by DCP itself
        if not isinstance(got, TensorStorageMetadata):
            raise ValueError(f"checkpoint has no tensor {key!r}")
        if tuple(got.size) != tuple(t.shape):
            raise ValueError(f"checkpoint tensor {key!r} has shape "
                             f"{tuple(got.size)}, the template "
                             f"{tuple(t.shape)}")
    saved = torch.load(os.path.join(path, _META), map_location="cpu",
                       weights_only=True)
    tensors = {k: torch.empty_like(t) for k, t in want["tensors"].items()}
    dcp.load({"tensors": tensors},
             storage_reader=dcp.FileSystemReader(path))
    return dict(saved, tensors=tensors)


def restore_state(path: str, template: Any) -> Any:
    """Read a state written by `save_state`; each tensor leaf takes the
    dtype and device of the template's leaf at the same path (and, from a
    sharded checkpoint's directory, its placements)."""
    path = os.path.abspath(path)
    if os.path.isdir(path):
        saved = _load_sharded(path, template)
    else:
        saved = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(saved, dict) or saved.get("format") != _FORMAT:
        raise ValueError(f"{path} is not a paropt_torch checkpoint")
    if saved["class"] != _qualname(template):
        raise ValueError(f"checkpoint holds a {saved['class']}, the "
                         f"template is a {_qualname(template)}")
    return _rebuild(template, "", saved)
