"""Frozen-dataclass helpers that stand in for JAX pytrees.

A state object is a frozen dataclass whose tensor fields are mapped and
whose ``static_field`` fields (configuration strings, layout names) pass
through unchanged.  `pytree` registers such a dataclass with
``torch.utils._pytree`` (tensor fields as children, static fields in the
context), so ``torch.func`` transforms see through it; `bvmap` runs a
function of such states under ``torch.func.vmap`` with JAX's ``in_axes``
meaning: a prefix tree of 0 or None per argument."""

from __future__ import annotations

import dataclasses

import torch
from torch.utils import _pytree as pt

__all__ = ["static_field", "tmap", "pytree", "bvmap", "take"]


def static_field(default=dataclasses.MISSING):
    """A dataclass field that `tmap` copies instead of mapping."""
    return dataclasses.field(default=default, metadata={"static": True})


def tmap(fn, first, *rest):
    """Apply ``fn`` field by field to the tensors of one or more dataclasses
    of the same type (nested dataclasses and NamedTuples recurse; None
    stays None; static fields come from ``first``)."""
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(
            None if a is None else tmap(fn, a, *(o[i] for o in rest))
            for i, a in enumerate(first)))
    if not dataclasses.is_dataclass(first):
        return fn(first, *rest)
    out = {}
    for f in dataclasses.fields(first):
        a = getattr(first, f.name)
        if f.metadata.get("static") or a is None:
            out[f.name] = a
        else:
            out[f.name] = tmap(fn, a, *(getattr(o, f.name) for o in rest))
    return dataclasses.replace(first, **out)


def pytree(cls):
    """Class decorator: register a frozen dataclass as a pytree node.
    Unflattening sets the fields directly (no ``__init__`` or
    ``__post_init__``), so a tree of axes (0 / None per field) rebuilds
    as well as a tree of tensors."""
    fields = dataclasses.fields(cls)
    dyn = tuple(f.name for f in fields if not f.metadata.get("static"))
    static = tuple(f.name for f in fields if f.metadata.get("static"))

    def flatten(obj):
        return ([getattr(obj, n) for n in dyn],
                tuple(getattr(obj, n) for n in static))

    def unflatten(children, context):
        obj = object.__new__(cls)
        for n, v in zip(dyn, children):
            object.__setattr__(obj, n, v)
        for n, v in zip(static, context):
            object.__setattr__(obj, n, v)
        return obj

    pt.register_pytree_node(
        cls, flatten, unflatten,
        serialized_type_name=f"{cls.__module__}.{cls.__qualname__}")
    return cls


def bvmap(fn, in_axes, *args):
    """``torch.func.vmap(fn)(*args)`` over a leading instance axis, with
    ``in_axes`` a prefix tree of the arguments (a tuple with one entry per
    argument; each entry 0, None, or a tree of them).  Non-tensor leaves
    (None fields, Python scalars) pass through on both sides; every tensor
    output carries the instance axis first."""
    flat, spec = pt.tree_flatten(args)
    dims = pt._broadcast_to_and_flatten(tuple(in_axes), spec)
    if dims is None:
        raise ValueError("in_axes does not match the arguments' structure")
    pos = [i for i, a in enumerate(flat) if isinstance(a, torch.Tensor)]
    meta = {}

    def inner(*tensors):
        leaves = list(flat)
        for i, t in zip(pos, tensors):
            leaves[i] = t
        out = fn(*pt.tree_unflatten(leaves, spec))
        oflat, meta["spec"] = pt.tree_flatten(out)
        meta["leaves"] = oflat
        return tuple(o for o in oflat if isinstance(o, torch.Tensor))

    res = iter(torch.func.vmap(inner, in_dims=tuple(dims[i] for i in pos))(
        *(flat[i] for i in pos)))
    leaves = [next(res) if isinstance(o, torch.Tensor) else o
              for o in meta["leaves"]]
    return pt.tree_unflatten(leaves, meta["spec"])


def take(tree, i):
    """Instance ``i`` of a batched tree (every tensor leaf indexed on its
    leading axis)."""
    return pt.tree_map(
        lambda a: a[i] if isinstance(a, torch.Tensor) else a, tree)
