#!/usr/bin/env python3
"""Where the time of one paropt_torch fused IP step goes, on a CUDA card.

    python3 scripts/torch_profile_step.py [--n 1048576] [--steps 5] [--table PATH]

Builds the chip_smoke.py slice (SyntheticTopology, float32, in-loop L-BFGS
msub 10, abs_res_tol 1e-6, no refinement), takes 3 warm-up steps, then

- times 10 steps with the host clock, synchronised after each step;
- profiles ``--steps`` steps with torch.profiler and prints the device time
  by phase (the step's ``paropt.*`` record_function ranges) and by kernel,
  and the device's busy and idle shares of the profiled window.

With ``--table PATH`` the full key_averages table is written to PATH.
Needs a CUDA card; prints nvidia-smi's name and power limit first.
"""

import argparse
import statistics
from collections import defaultdict
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1 << 20)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--table", type=Path, default=None,
                    help="write the profiler's key_averages table here")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    from paropt_torch import ip_fused
    from paropt_torch.models.topology import SyntheticTopology
    from paropt_torch.ops import qn as qnmod

    dtype = torch.float32
    prob = SyntheticTopology(n=args.n, block=8, dtype=dtype, device="cuda")
    opts = ip_fused.FusedIPOptions(use_quasi_newton_update=True,
                                   abs_res_tol=1e-6,
                                   iterative_refinement_steps=0)
    fused = ip_fused.FusedIP(ip_fused.model_from_problem(prob), prob.nvars,
                             prob.ncon, prob.nwcon, prob.nwblock, opts,
                             dtype=dtype)
    data, x0 = ip_fused.data_template_from_problem(prob, dtype=dtype)
    state = fused.init(x0, data, (),
                       qnmod.qn_init(10, prob.nvars, dtype=dtype,
                                     device="cuda"), None)
    for _ in range(3):
        state = fused.step(state, data, (), None)
    torch.cuda.synchronize()

    walls = []
    syncs0 = fused.syncs.count
    for _ in range(10):
        t0 = time.perf_counter()
        state = fused.step(state, data, (), None)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    print(f"[step] n={args.n} host-clock step time: median "
          f"{statistics.median(walls) * 1e3:.3f} ms, min "
          f"{min(walls) * 1e3:.3f} ms over 10 steps; "
          f"{(fused.syncs.count - syncs0) / 10:.1f} host syncs/step")

    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            state = fused.step(state, data, (), None)
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    from torch.autograd import DeviceType
    evts = prof.events()
    on_dev = [e for e in evts if e.device_type == DeviceType.CUDA]
    ranges = [e for e in on_dev if e.name.startswith("paropt.")]
    kernels = [e for e in on_dev if not e.name.startswith("paropt.")]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    per = 1.0 / args.steps
    print(f"[profile] {args.steps} steps in {window * 1e3:.3f} ms "
          f"(profiler on); device busy {busy_us * 1e-3 * per:.3f} ms/step = "
          f"{100 * busy_us * 1e-6 / window:.1f}% of the window, idle "
          f"{100 * (1 - busy_us * 1e-6 / window):.1f}%; "
          f"{len(kernels) * per:.0f} kernels/step")
    step_ms = statistics.median(walls) * 1e3
    print(f"[profile] against the unprofiled median step ({step_ms:.3f} ms): "
          f"device busy {100 * busy_us * 1e-3 * per / step_ms:.1f}%")
    # device time of the kernels inside each phase's device-side range,
    # host time of the phase's host-side range
    phase_dev = defaultdict(float)
    for r in ranges:
        lo, hi = r.time_range.start, r.time_range.end
        phase_dev[r.name] += sum(k.time_range.elapsed_us() for k in kernels
                                 if lo <= k.time_range.start < hi)
    phase_host = defaultdict(float)
    for e in evts:
        if e.device_type == DeviceType.CPU and e.name.startswith("paropt."):
            phase_host[e.name] += e.time_range.elapsed_us()
    for name in sorted(phase_host, key=lambda k: -phase_host[k]):
        print(f"[phase] {name}: host {phase_host[name] * 1e-3 * per:.3f} "
              f"ms/step, device busy {phase_dev[name] * 1e-3 * per:.3f} "
              f"ms/step")
    by_name = defaultdict(lambda: [0.0, 0])
    for k in kernels:
        by_name[k.name][0] += k.time_range.elapsed_us()
        by_name[k.name][1] += 1
    for name, (us, cnt) in sorted(by_name.items(),
                                  key=lambda kv: -kv[1][0])[:15]:
        print(f"[kernel] {us * 1e-3 * per:.4f} ms/step x{cnt * per:.0f}  "
              f"{name[:90]}")
    if args.table is not None:
        args.table.parent.mkdir(parents=True, exist_ok=True)
        args.table.write_text(prof.key_averages().table(
            sort_by="self_cuda_time_total", row_limit=80))


if __name__ == "__main__":
    main()
