"""torch.profiler over one sub-window of a run, reduced to what the
per-layer readers need.

The profiler (CPU and CUDA activities) is started and stopped by the job
at two synchronized instants.  The shapes of the custom-op calls are
recorded by thin wrappers over the kernel wrappers' module attributes
while the profiler runs (the profiler's own ``record_shapes`` keeps every
op's inputs alive to the end: a profiled 2^24 solve then peaked at 72 GB
against 12 GB unprofiled).  Its chrome-trace
export is written under TMPDIR, read once and deleted: parsing the
profiler's Python events took minutes for ~90,000 device ops, the JSON
seconds.  What is kept (`Trace`):

- the sub-window's host seconds and the device's busy seconds in it (the
  union of kernel, memcpy and memset intervals);
- per record_function range name: the host seconds of its ranges, their
  count, and the device seconds of the ops that ran inside the range's
  device-side span;
- per call of the port's custom ops (`roofline.MODELS`): its input dims
  and item size and the device seconds of the kernels it launched (linked
  by the launch's correlation id); an op whose logged calls and traced
  calls differ in number is listed as unmatched, and none of its calls
  is kept;
- the device ops by name and the idle gaps by the host range open at
  their start, for the `breakdown` of the result line.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict
from dataclasses import dataclass, field

from . import roofline

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
TOP = 10
NAME_CHARS = 160     # a kernel's name in the breakdown, its template cut


@dataclass
class Trace:
    window_s: float
    busy_s: float
    range_host_s: dict = field(default_factory=dict)
    range_count: dict = field(default_factory=dict)
    range_device_s: dict = field(default_factory=dict)
    op_calls: list = field(default_factory=list)   # (name, dims, size, s)
    unmatched: list = field(default_factory=list)  # (name, logged, traced)
    device_ops: list = field(default_factory=list)  # [(name, s)], top 10
    idle_gaps: list = field(default_factory=list)   # [(range, s)], top 10
    units: dict = field(default_factory=dict)       # job counts inside

    def device_s(self, name: str):
        return self.range_device_s.get(name)


class Profiler:
    """Start and stop torch.profiler at synchronized instants; `stop`
    returns the reduced `Trace`."""

    def __init__(self, clock, device):
        self.clock = clock
        self.device = device
        self.prof = None
        self.t0 = None
        self.calls = []
        self._saved = {}

    def _record_shapes(self):
        from paropt_torch.ops import kernels
        for op in roofline.MODELS:
            name = op.split("::")[1]
            self._saved[name] = getattr(kernels, name)
            setattr(kernels, name,
                    _recording(op, self._saved[name], self.calls))

    def _restore(self):
        from paropt_torch.ops import kernels
        for name, fn in self._saved.items():
            setattr(kernels, name, fn)
        self._saved = {}

    def start(self):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.cuda:
            acts.append(ProfilerActivity.CUDA)
        self.device.sync()
        self._record_shapes()
        self.prof = profile(activities=acts)
        self.prof.start()
        self.t0 = self.clock()

    def stop(self) -> Trace:
        self.device.sync()
        window = self.clock() - self.t0
        self.prof.stop()
        self._restore()
        fd, path = tempfile.mkstemp(prefix="portbench_trace_",
                                    suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        self.prof = None
        return reduce_events(events, window, self.calls)


def _recording(op, fn, log):
    """``fn`` that first logs (op, input dims, item size) of its call."""
    import torch

    def call(*args):
        ts = [a for a in args if isinstance(a, torch.Tensor)]
        log.append((op, [list(a.shape) if isinstance(a, torch.Tensor)
                         else [] for a in args], ts[0].element_size()))
        return fn(*args)
    return call


def _merged(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce_events(events, window_s: float, calls=()) -> Trace:
    """A `Trace` from chrome-trace events (times in microseconds) and the
    logged custom-op calls, matched in order to the trace's op events."""
    xs = [e for e in events if e.get("ph") == "X"]
    dev = [e for e in xs if e.get("cat") in DEVICE_CATS]
    busy = _merged((e["ts"], e["ts"] + e["dur"]) for e in dev)
    tr = Trace(window_s=window_s,
               busy_s=sum(b - a for a, b in busy) * 1e-6)

    host = defaultdict(list)
    gpu = defaultdict(list)
    for e in xs:
        if e.get("cat") == "user_annotation":
            host[e["name"]].append((e["ts"], e["ts"] + e["dur"]))
        elif e.get("cat") == "gpu_user_annotation":
            gpu[e["name"]].append((e["ts"], e["ts"] + e["dur"]))
    dev_ts = sorted((e["ts"], e["dur"]) for e in dev)
    starts = [t for t, _ in dev_ts]
    for name, spans in host.items():
        tr.range_host_s[name] = sum(b - a for a, b in spans) * 1e-6
        tr.range_count[name] = len(spans)
    for name, spans in gpu.items():
        total = 0.0
        for a, b in _merged(spans):
            i, j = bisect.bisect_left(starts, a), bisect.bisect_left(starts, b)
            total += sum(d for _, d in dev_ts[i:j])
        tr.range_device_s[name] = total * 1e-6

    # custom-op calls: the kernels their launches started, by correlation
    kernel_s = defaultdict(float)
    for e in dev:
        corr = e.get("args", {}).get("correlation")
        if corr is not None:
            kernel_s[corr] += e["dur"] * 1e-6
    launches = defaultdict(list)
    for e in xs:
        if e.get("cat") in LAUNCH_CATS:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launches[e.get("tid")].append((e["ts"], corr))
    for lst in launches.values():
        lst.sort()
    ops = defaultdict(list)
    for e in sorted((e for e in xs if e.get("cat") == "cpu_op"
                     and e["name"] in roofline.MODELS),
                    key=lambda e: e["ts"]):
        lst = launches.get(e.get("tid"), [])
        i = bisect.bisect_left(lst, (e["ts"], -1))
        j = bisect.bisect_right(lst, (e["ts"] + e["dur"], float("inf")))
        ops[e["name"]].append(sum(kernel_s.get(c, 0.0) for _, c in lst[i:j]))
    logged = defaultdict(list)
    for op, dims, size in calls:
        logged[op].append((dims, size))
    for op in sorted(set(ops) | set(logged)):
        secs = ops.get(op, [])
        if len(logged[op]) != len(secs):    # the calls cannot be told apart
            tr.unmatched.append((op, len(logged[op]), len(secs)))
            continue
        tr.op_calls += [(op, dims, size, t)
                        for (dims, size), t in zip(logged[op], secs)]

    by_name = defaultdict(float)
    for e in dev:
        by_name[e["name"][:NAME_CHARS]] += e["dur"] * 1e-6
    tr.device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    tr.idle_gaps = _idle_gaps(busy, host)
    return tr


def _idle_gaps(busy, host):
    """Idle seconds between device ops, by the innermost paropt range open
    on the host when the gap began ('(none)' outside every range)."""
    ranges = sorted((a, b, name) for name, spans in host.items()
                    for a, b in spans)
    gaps = defaultdict(float)
    stack = []      # open ranges (end, name), innermost last
    i = 0
    for (_, end), (nxt, _) in zip(busy, busy[1:]):
        while i < len(ranges) and ranges[i][0] <= end:
            stack.append((ranges[i][1], ranges[i][2]))
            i += 1
        stack = [s for s in stack if s[0] > end]
        gaps[stack[-1][1] if stack else "(none)"] += (nxt - end) * 1e-6
    return sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]

