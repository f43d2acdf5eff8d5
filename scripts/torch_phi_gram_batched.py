#!/usr/bin/env python3
"""Where the time of phi_gram's instance-axis launch goes, on one CUDA card.

    python3 scripts/torch_phi_gram_batched.py

Two shapes, float32, B = 21 as the factor setup calls it (the stack as its
Z_qn rows and A's row, bw = 0), vals shared by the instances (stride 0):
chip_smoke.py phase 3b's (kb = 4, k = 8, nwcon = 2^17) and phase 22's
(kb = 32, k = 8, nwcon = 512).  For each:

- the instance-axis launch on the stack sliced from one [kb, 21, k, nwcon]
  tensor, as phase 3b passes it; on the same stack with its Z_qn block
  contiguous; and kb single launches: each held bit for bit against the
  single launches, then timed with chip_smoke.py's timer (CUDA events,
  median of 20 runs, L2 flushed);
- torch.profiler's device time per kernel name over 10 calls of each, from
  the profiler's chrome-trace export;
- at phase 3b's shape, the instance-axis launch at kb = 1, 2, 3, 4 on
  contiguous operands (the cost of each further instance);
- SHA-256 digests of the single launch's outputs at the main path's
  shape in float32 and float64 (as the factor setup calls it, and whole
  with bw) from fixed inputs: equal digests from two checkouts mean
  bit-equal single launches.

The script uses only the wrapper's public functions, so it runs unchanged
from an older checkout (copy it into that checkout's ``scripts/``) to
compare two versions in one call.  It prints the card's name and power
limit first and one JSON line per measurement.
"""

import json
import os
import shutil
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from paropt_torch.ops import kernels  # noqa: E402

B, K_ROWS, REPS = 2 * cs.MSUB + 1, cs.BLOCK, 10


def stack(kb, W, gen):
    """Operands of kb instances: dinv, cwinv [kb, ...], vals shared, the
    [kb, 21, k, W] stack."""
    per = [cs._qd_inputs(torch, gen, B, K_ROWS, W, torch.float32)
           for _ in range(kb)]
    dinv, cwinv, vals, bx = (torch.stack([p[j] for p in per])
                             for j in range(4))
    return dinv, cwinv, vals[0].expand(kb, K_ROWS, W), bx


def device_ms_by_kernel(fn):
    """{kernel name: (launches, device ms per call)} over REPS calls of
    fn under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    path = cs.BUILD / f"phi_gram_batched_trace_{os.getpid()}.json"
    cs.BUILD.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    path.unlink()
    out = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in cs.DEVICE_OP_CATS:
            name = e["name"].split("<")[0].split("(")[0][:48]
            n, ms = out.get(name, (0, 0.0))
            out[name] = (n + 1, ms + e["dur"] * 1e-3)
    return {k: (n // REPS, ms / REPS) for k, (n, ms) in out.items()}


def measure(tag, kb, W, gen):
    dinv, cwinv, vals, bx = stack(kb, W, gen)
    sliced = (dinv, cwinv, vals, bx[:, :2 * cs.MSUB], None,
              bx[:, 2 * cs.MSUB:])
    whole = (dinv, cwinv, vals, bx[:, :2 * cs.MSUB].contiguous(), None,
             bx[:, 2 * cs.MSUB:])

    def pick(args, i):
        return [None if a is None else a[i] for a in args]

    singles = [kernels.phi_gram(*pick(sliced, i)) for i in range(kb)]
    for args in (sliced, whole):
        got = kernels.phi_gram_batched(*args)
        for i, one in enumerate(singles):
            cs.check(all(torch.equal(g[i], s) for g, s in zip(got, one)),
                     f"{tag}: instance {i} differs from its single launch")
    fns = {
        "batched_sliced": lambda: kernels.phi_gram_batched(*sliced),
        "batched_contiguous": lambda: kernels.phi_gram_batched(*whole),
        "singles": lambda: [kernels.phi_gram(*pick(sliced, i))
                            for i in range(kb)],
    }
    nbytes = cs._nbytes(dinv, cwinv, vals[0], bx) + kb * cs._nbytes(
        *singles[0])
    bms, by = cs.bound_ms(nbytes, kb * (2 * B * B * K_ROWS * W
                                        + B * W * (6 * K_ROWS + 2)))
    # every timing before the first profiler session; kb single launches
    # in 5 runs where 20 would pass ~1,000 pending launches (the timer
    # enqueues every run behind a spin)
    times = {name: timed(fn, reps=20 if kb <= 4 else 5)
             for name, fn in fns.items()}
    for name, fn in fns.items():
        t0 = time.perf_counter()
        fn()
        host = time.perf_counter() - t0
        torch.cuda.synchronize()
        ms = times[name]
        row = {"shape": tag, "kb": kb, "nwcon": W, "call": name,
               "ms": ms, "bound_ms": bms, "bound_by": by,
               "share": ms and bms / ms, "host_enqueue_ms": host * 1e3,
               "kernels": device_ms_by_kernel(fn), "smi": cs.smi_sample()}
        print(json.dumps(row), flush=True)


def timed(fn, reps=20):
    """chip_smoke.py's timer, or None where the host could not enqueue
    the runs ahead of the device."""
    try:
        return cs.cuda_ms(torch, fn, reps=reps)
    except SystemExit as exc:
        print(f"[phi_gram batched] not measured: {exc}", flush=True)
        return None


def single_digests(gen):
    """{label: SHA-256 of the single launch's three outputs} at the main
    path's shape."""
    import hashlib
    W = cs.N_MAIN // cs.BLOCK
    out = {}
    for dt in (torch.float32, torch.float64):
        dinv, cwinv, vals, bx, bw = cs._qd_inputs(torch, gen, B, K_ROWS, W,
                                                  dt)
        for label, args in (
                ("split", (dinv, cwinv, vals, bx[:2 * cs.MSUB], None,
                           bx[2 * cs.MSUB:])),
                ("whole_bw", (dinv, cwinv, vals, bx, bw, None))):
            h = hashlib.sha256()
            for t in kernels.phi_gram(*args):
                h.update(t.cpu().numpy().tobytes())
            out[f"{str(dt).split('.')[1]} {label}"] = h.hexdigest()[:16]
    return out


def main():
    cs.phase_device(torch)
    t0 = time.perf_counter()
    from paropt_torch.ops import _build
    _build.load_library()
    print(f"[phi_gram batched] library ready in "
          f"{time.perf_counter() - t0:.1f} s; ncu: {shutil.which('ncu')}",
          flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    W = cs.N_MAIN // cs.BLOCK
    plan = kernels.phi_gram_plan(B, K_ROWS, 4, False)
    print(json.dumps({"plan": plan._asdict(),
                      "sms": torch.cuda.get_device_properties(
                          0).multi_processor_count}), flush=True)
    print(json.dumps({"single_digests": single_digests(gen)}), flush=True)
    measure("phase 3b", 4, W, gen)
    measure("phase 22", 32, 512, gen)
    dinv, cwinv, vals, bx = stack(4, W, gen)
    top = bx[:, :2 * cs.MSUB].contiguous()
    for kb in (1, 2, 3, 4):
        args = (dinv[:kb], cwinv[:kb], vals[:kb], top[:kb], None,
                bx[:kb, 2 * cs.MSUB:])
        print(json.dumps({"sweep": "phase 3b shape, contiguous", "kb": kb,
                          "ms": timed(lambda: kernels.phi_gram_batched(
                              *args))}), flush=True)


if __name__ == "__main__":
    main()
