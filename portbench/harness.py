"""The benchmark harness of paropt_torch, driven by BENCHMARK.json.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell names a configuration and a traffic mix.  The configuration is
`configs/<config>.json` (sizes, dtype, solver options), the mix
`traffic/<traffic>.json`, whose ``job`` names the module in `jobs/` that
runs it; the plain reference is `reference/<config>.py`, the limits of the
comparison `limits/<cell>.json`; each metric is read by `metrics/<name>.py`
(a dotted name by the part before the dot).
Nothing here names a cell, a configuration or a metric.

A run: set-up (the model and solver built from the configuration on the
card, every shape of the cell warmed), the measured window of ``--seconds``
(ending as the job's traffic says), the end-to-end metrics (``--trace 0``)
or the per-layer ones (``--trace 1``, the profiler over a sub-window),
then, once the program is freed, the comparison with the plain reference
that decides ``correct``.  Each compared number is printed with its limit
as the last lines of standard error and under ``compared`` as the last
key of the result, the last line of standard output.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "paropt_tpu")


def _process_age_s() -> float:
    """Seconds since this process started (its start time in /proc, in
    clock ticks since boot, against the uptime); 0 where /proc has none."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


def clock() -> float:
    return time.perf_counter()


PROCESS_START = clock() - _process_age_s()


@dataclass
class Run:
    """What a job hands back: its window and counts, the traced
    sub-window, and what the check needs."""
    setup_s: float
    window_s: float
    peak_bytes: int           # max_memory_allocated over the window
    process_peak_bytes: int   # over set-up and window
    attempted: int
    failed: int
    units: dict = field(default_factory=dict)
    trace: object = None      # trace.Trace of the profiled sub-window
    answers: dict = field(default_factory=dict)
    per_design_iters: list = field(default_factory=list)
    setup_parts: dict = field(default_factory=dict)  # phase -> seconds


# the clock at the end of the set-up phases the harness itself runs (torch
# imported and its CUDA context made), ahead of the job's own
MARKS: dict = {}


def phases(ends: dict) -> dict:
    """Seconds of each set-up phase, from `MARKS` and then the job's
    ``ends`` (its clock at the end of each phase, in order), the first
    from the process's start."""
    out, t = {}, PROCESS_START
    for name, end in {**MARKS, **ends}.items():
        out[name], t = end - t, end
    return out


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def load_manifest(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def cell_of(manifest: dict, name: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def reported(metrics: list, cell: str) -> list:
    """The metric entries a cell reports: those that list it, or list no
    cells."""
    return [m for m in metrics if cell in m.get("workloads", [cell])]


def read_metric(name: str, run: Run, traffic: dict):
    """The value of metric ``name`` from its reader in `metrics/`, or None
    where the reader finds nothing to read."""
    base, _, part = name.partition(".")
    reader = importlib.import_module(f"portbench.metrics.{base}")
    return reader.read(run, part or None, traffic)


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def _cache_dirs():
    """Every build and kernel cache inside the checkout, at fixed paths
    (the kernels' own build directory is build/ there already)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "build" / sub)


def power_limit() -> str:
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired) as err:
        return f"nvidia-smi failed: {err}"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else f"nvidia-smi failed: {out.stderr.strip()}"


class Device:
    """The device a run uses, and what the harness reads of it: the CUDA
    card, or the CPU for the tests' rehearsals (no memory readings)."""

    def __init__(self, name: str = "cuda"):
        import torch
        self.torch = torch
        self.name = name
        self.cuda = name == "cuda"

    def sync(self):
        if self.cuda:
            self.torch.cuda.synchronize()

    def peak_bytes(self) -> int:
        return self.torch.cuda.max_memory_allocated() if self.cuda else 0

    def reset_peak(self):
        if self.cuda:
            self.torch.cuda.reset_peak_memory_stats()

    def free(self):
        if self.cuda:
            self.torch.cuda.empty_cache()


def execute(args, manifest: dict, device: Device, config=None,
            limits=None, root: Path = ROOT):
    """The run of a cell after the look for a card: (result dict, stderr
    lines).  ``config`` and ``limits`` replace the cell's files (the tests
    run the same path at a size the CPU holds)."""
    cell = cell_of(manifest, args.workload)
    if config is None:
        conf = next(c for c in manifest["configs"]
                    if c["name"] == cell["config"])
        config = load_json(root / conf["file"])
    traffic = load_json(BENCH / "traffic" / f"{cell['traffic']}.json")
    if limits is None:
        limits = load_json(BENCH / "limits" / f"{cell['name']}.json")

    job = importlib.import_module(f"portbench.jobs.{traffic['job']}")
    run = job.run(config, traffic, args.seed, args.seconds, bool(args.trace),
                  device)
    bad = forbidden_modules()
    if bad:
        raise Forbidden(bad)
    section = manifest["per_layer"] if args.trace else manifest["end_to_end"]
    metrics = {}
    for m in reported(section, cell["name"]):
        value = read_metric(m["name"], run, traffic)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    info = {"platform": "gpu" if device.cuda else "cpu",
            "kind": (device.torch.cuda.get_device_name(0) if device.cuda
                     else "cpu"),
            "count": cell["chips"], "memory_peak_bytes": run.process_peak_bytes}
    if run.trace is not None:
        info["busy_s"] = run.trace.busy_s
        info["window_s"] = run.trace.window_s

    reference = importlib.import_module(
        f"portbench.reference.{cell['config']}")
    device.free()
    t_check = clock()
    compared = {k: (v, limits[k]) for k, v in
                job.check(run, config, traffic, reference, args.seed,
                          device).items()}
    t_check = clock() - t_check
    correct = (run.attempted > 0 and run.failed == 0
               and all(v <= lim for v, lim in compared.values()))
    bad = forbidden_modules()
    if bad:
        raise Forbidden(bad)
    result = {"correct": correct, "attempted": run.attempted,
              "failed": run.failed, "metrics": metrics, "device": info}
    if run.trace is not None:
        result["breakdown"] = {
            "device_ops": [[n, s] for n, s in run.trace.device_ops],
            "idle_gaps": [[n, s] for n, s in run.trace.idle_gaps]}
    card = power_limit() if device.cuda else "cpu"
    result["card"] = card
    result["compared"] = {k: {"value": v, "limit": lim}
                          for k, (v, lim) in compared.items()}
    lines = [f"portbench: {cell['name']} seed {args.seed}: card {card}; "
             f"attempted {run.attempted}, failed {run.failed}; window "
             f"{run.window_s:.3f} s, set-up {run.setup_s:.3f} s, check "
             f"{t_check:.3f} s; counts {run.units}; set-up by phase "
             f"{ {k: round(v, 3) for k, v in run.setup_parts.items()} }"]
    lines += [f"compared {k} {v!r} limit {lim!r}"
              for k, (v, lim) in compared.items()]
    return result, lines


class Forbidden(RuntimeError):
    """The run loaded JAX or the JAX package."""


def main(argv=None) -> int:
    args = parse(argv)
    manifest = load_manifest()
    cell = cell_of(manifest, args.workload)
    _cache_dirs()
    import torch
    if torch.cuda.is_available():
        torch.cuda.init()
    MARKS["torch"] = clock()
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {cell['name']} needs {cell['chips']} CUDA "
              f"card(s); torch sees {seen}", file=sys.stderr)
        return 2
    try:
        result, lines = execute(args, manifest, Device("cuda"))
    except Forbidden as err:
        print(f"portbench: the run loaded {', '.join(err.args[0])}",
              file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
