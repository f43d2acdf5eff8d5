"""Named spans over the port's host phases, for torch.profiler traces.

Every range the port emits goes through here:

- ``span(name)``: a context manager.  While a torch profiler is collecting
  (checked at entry) it is ``torch.profiler.record_function(name)``;
  otherwise it is one shared null context, and no torch call is made.
- ``spanned(name)``: the same as a decorator, checked at each call.

The profiler's trace is the store and the clock: there is no other state,
no option and no exporter.  A span's parent is the span that encloses it
in time on the same thread; the request a span belongs to is the
enclosing ``paropt.ip.solve`` (one `FusedIP` solve loop) or
``paropt.mma.outer`` (one `FusedMMA` outer iteration).  A span carries
only its name: ``record_function``'s args string does not reach the
chrome-trace export (torch 2.13).  The ranges collected share the device
trace's clock, so an idle gap of the device can be put down to the span
open on the host when it began; a gap that begins inside
``paropt.host_read`` is the device waiting on a read of a device value.

No span touches a tensor: results are bit for bit the same with the
profiler on and off.
"""

from __future__ import annotations

import contextlib
import functools

import torch
from torch.profiler import record_function

__all__ = ["span", "spanned", "HOST_READ"]

# `ip.HostSyncs`'s reads of device values on the host
HOST_READ = "paropt.host_read"

_NULL = contextlib.nullcontext()


def span(name: str):
    """``record_function(name)`` while a profiler collects, else a shared
    null context."""
    if torch.autograd._profiler_enabled():
        return record_function(name)
    return _NULL


def spanned(name: str):
    """Decorator: the function's calls run inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap
