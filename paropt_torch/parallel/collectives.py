"""The collectives a rank issues on sharded state: a count and a span.

``COUNTS`` holds the collectives this rank has issued since the last
`reset`, and the bytes of their local inputs (what the rank hands to
each), as ``ops.kernels.LAUNCHES`` holds the kernels' launches;
``BY_KIND`` splits them by the function called ([calls, bytes]).  The count
is taken by thin wrappers over the functions DTensor calls to move data
between placements: PyTorch's functional collectives and DTensor's
all-to-all between shard dimensions.  Every redistribution goes through
them, so the count covers DTensor's own collectives, the ``spmd`` mode's
settle all-reduces (`sharding.settle`), the kernels' sharding rules
(``ops/kernels.py``) and `ip.HostSyncs`'s whole reads of DTensors.  A
collective that calls another (the CPU's all-to-all is an all-gather)
counts once.

Each counted call runs inside the span ``paropt.collective``
(`utils.spans`), so a device trace names the collective's kernels and
an idle gap that begins while the host issues one.

The wrappers are installed only while `counting` is entered: the
``spmd`` entry points enter it when their arguments hold sharded state,
so a solve on plain tensors runs none of this code.
"""

from __future__ import annotations

import contextlib
import importlib
import threading

import torch

from ..utils.spans import span

__all__ = ["COUNTS", "BY_KIND", "SPAN", "reset", "counting", "installed"]

# collectives issued and bytes of their local inputs, since reset()
COUNTS = {"calls": 0, "bytes": 0}
# the same by the function called: name -> [calls, bytes]
BY_KIND: dict = {}
SPAN = "paropt.collective"

# (module, function) of every entry DTensor moves data through; a module
# or function this PyTorch lacks is skipped
_TARGETS = (
    ("torch.distributed._functional_collectives",
     ("all_reduce", "all_gather_tensor", "all_gather_single",
      "reduce_scatter_tensor", "reduce_scatter_single",
      "all_to_all_single")),
    # imported by name into placement_types, so wrapped in both
    ("torch.distributed.tensor._collective_utils", ("shard_dim_alltoall",)),
    ("torch.distributed.tensor.placement_types", ("shard_dim_alltoall",)),
)

_saved = []          # (module, name, original) while installed
_depth = 0           # nested `counting` contexts
_inside = threading.local()


def reset() -> None:
    COUNTS["calls"] = 0
    COUNTS["bytes"] = 0
    BY_KIND.clear()


def installed() -> bool:
    return bool(_saved)


def _nbytes(t) -> int:
    if isinstance(t, torch.Tensor):
        return t.numel() * t.element_size()
    if isinstance(t, (list, tuple)):
        return sum(_nbytes(a) for a in t)
    return 0


def _counted(fn, name):
    def call(t, *args, **kwargs):
        if getattr(_inside, "on", False):      # issued by a counted call
            return fn(t, *args, **kwargs)
        nbytes = _nbytes(t)
        COUNTS["calls"] += 1
        COUNTS["bytes"] += nbytes
        kind = BY_KIND.setdefault(name, [0, 0])
        kind[0] += 1
        kind[1] += nbytes
        _inside.on = True
        try:
            with span(SPAN):
                return fn(t, *args, **kwargs)
        finally:
            _inside.on = False
    call.__wrapped__ = fn
    return call


def _install() -> None:
    for modname, names in _TARGETS:
        try:
            mod = importlib.import_module(modname)
        except ImportError:
            continue
        for name in names:
            fn = getattr(mod, name, None)
            if fn is not None:
                _saved.append((mod, name, fn))
                setattr(mod, name, _counted(fn, name))


def _uninstall() -> None:
    while _saved:
        mod, name, fn = _saved.pop()
        setattr(mod, name, fn)


@contextlib.contextmanager
def counting():
    """The wrappers installed while entered (nested entries share one
    installation; the last exit restores the originals)."""
    global _depth
    if _depth == 0 and torch.distributed.is_available():
        _install()
    _depth += 1
    try:
        yield COUNTS
    finally:
        _depth -= 1
        if _depth == 0:
            _uninstall()
