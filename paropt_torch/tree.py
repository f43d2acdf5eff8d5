"""Frozen-dataclass helpers that stand in for JAX pytrees.

A state object is a frozen dataclass whose tensor fields are mapped and
whose ``static_field`` fields (configuration strings, layout names) pass
through unchanged."""

from __future__ import annotations

import dataclasses

__all__ = ["static_field", "tmap"]


def static_field(default=dataclasses.MISSING):
    """A dataclass field that `tmap` copies instead of mapping."""
    return dataclasses.field(default=default, metadata={"static": True})


def tmap(fn, first, *rest):
    """Apply ``fn`` field by field to the tensors of one or more dataclasses
    of the same type (nested dataclasses recurse; None stays None; static
    fields come from ``first``)."""
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
