#!/usr/bin/env python3
"""Smoke test of the paropt_torch port on one CUDA card.

    python3 chip_smoke.py

Phases (any failure raises and exits nonzero without the final line):

1. device: a CUDA card must be present; prints nvidia-smi's name and power
   limit, turns TF32 off and checks it;
2. build: compiles the CUDA kernels from paropt_torch/csrc with nvcc;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the main path's shapes and at one ragged size, with the device time of
   both (CUDA events, median of 20 runs after warm-up, L2 flushed);
4. slice: the fused interior-point solve of SyntheticTopology at n = 2^20
   in float32 (in-loop L-BFGS, msub 10, abs_res_tol 1e-6, no refinement),
   which must converge and must launch every kernel;
5. cross-check: the same solve at n = 2^14 in float64 on the card (kernels)
   and on the host (plain versions) must agree in iteration count and
   objective.

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.  Only torch and numpy are used.
"""

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# one row per kernel: wrapper name -> (source, replaced Pallas kernel)
KERNELS = {
    "qn_roll_update": ("paropt_torch/csrc/qn_roll.cu",
                       "paropt_tpu/ops/pallas_kernels.py:68"),
    "quasi_def_apply": ("paropt_torch/csrc/quasi_def.cu",
                        "paropt_tpu/ops/pallas_kernels.py:258"),
    "phi_gram": ("paropt_torch/csrc/quasi_def.cu",
                 "paropt_tpu/ops/pallas_kernels.py:210"),
}
# relative tolerance of kernel against plain version: f64 exposes indexing
# faults; f32 (and bf16 storage, which accumulates in f32) differ only by
# summation order (tile/tree sums in the kernel, BLAS/reduction order in
# torch), a few ulps of the accumulated magnitude
RTOL = {"float64": 1e-12, "float32": 1e-5, "bfloat16": 1e-5}
N_MAIN = 1 << 20
MSUB = 10
BLOCK = 8
L2_FLUSH_BYTES = 256 << 20   # written between timed runs; the L2 is 50 MB
SPIN_CYCLES = 100_000_000    # ~50 ms at the H100's clock


def log(msg):
    print(msg, flush=True)


def check(cond, msg):
    if not cond:
        raise SystemExit(f"chip_smoke: FAIL: {msg}")


def cuda_ms(torch, fn, reps=20, warmup=3):
    """Median device time of fn() in milliseconds over `reps` runs, each
    between a pair of CUDA events, with the L2 cache flushed before each run
    (an upper bound for a caller whose operands are partly in L2).  A spin
    kernel holds the stream while the host enqueues every run, so the
    events time the device's work and not the host's Python and launch
    overhead; if the host outran the spin, the spin is lengthened."""
    for _ in range(warmup):
        fn()
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    spin = SPIN_CYCLES
    for _ in range(4):
        events = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True))
                  for _ in range(reps)]
        torch.cuda.synchronize()
        torch.cuda._sleep(spin)
        for start, stop in events:
            flush.zero_()
            start.record()
            fn()
            stop.record()
        # still spinning (or in the first run) once all runs are enqueued:
        # no run waited for the host
        held = not events[0][1].query()
        torch.cuda.synchronize()
        if held:
            return statistics.median(s.elapsed_time(e) for s, e in events)
        spin *= 4
    raise SystemExit("chip_smoke: FAIL: the host could not enqueue the timed "
                     "runs ahead of the device")


def rel_err(torch, got, want):
    """(max abs error, max abs error / max |want|), in float64."""
    got = got.double()
    want = want.double()
    err = torch.max(torch.abs(got - want)).item()
    scale = max(torch.max(torch.abs(want)).item(), 1e-300)
    return err, err / scale


def phase_device(torch):
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    log(smi.stdout.strip().splitlines()[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmul is on")
    check(not torch.backends.cudnn.allow_tf32, "cuDNN TF32 is on")
    log(f"[device] {torch.cuda.get_device_name(0)} "
        f"count={torch.cuda.device_count()} torch={torch.__version__} "
        f"cuda={torch.version.cuda}")


def phase_build():
    from paropt_torch.ops import _build
    t0 = time.perf_counter()
    _build.load_library()
    wall = time.perf_counter() - t0
    nvcc = (f"{_build.build_seconds:.2f} s" if _build.build_seconds
            else "cached")
    log(f"[build] kernels ready in {wall:.2f} s (nvcc {nvcc})")
    logfile = _build.BUILD_ROOT / _build.source_hash() / "build.log"
    if logfile.exists():
        # ptxas -v: each kernel's name, then its spills and registers
        for line in logfile.read_text().splitlines():
            if "entry function" in line:
                log(f"[build] {line.split(chr(39))[1][:60]}")
            elif "registers" in line or "spill" in line:
                log(f"[build]   {line.strip()}")


def _qd_inputs(torch, gen, K, k, W, dtype):
    kw = dict(device="cuda", dtype=dtype, generator=gen)
    dinv = 0.5 + 1.5 * torch.rand((k, W), **kw)
    vals = torch.randn((k, W), **kw)
    c0 = 0.5 + torch.rand((W,), **kw)
    cwinv = 1.0 / (c0 + torch.sum(vals ** 2 * dinv, dim=0))
    bx = torch.randn((K, k, W), **kw)
    bw = torch.randn((K, W), **kw)
    return dinv, cwinv, vals, bx, bw


def phase_kernels(torch):
    """Each kernel against its plain version; returns per-kernel results at
    the main path's shapes in float32."""
    from paropt_torch.ops import kernels
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    out = {}

    def compare(name, label, got, want, dtype_name, exact=()):
        worst = 0.0
        for g, w in exact:
            check(torch.equal(g, w), f"{name} {label}: buffer differs")
        for g, w in zip(got, want):
            err, rel = rel_err(torch, g, w)
            check(rel <= RTOL[dtype_name],
                  f"{name} {label}: relative error {rel:.3e} > "
                  f"{RTOL[dtype_name]:.0e}")
            worst = max(worst, err)
        torch.cuda.synchronize()
        log(f"[kernels] {name} {label}: max abs err {worst:.3e}")
        return worst

    # 1. qn_roll_update: [2m, n] buffer in f32 / f64 / bf16, upd both ways
    for n in (N_MAIN, 1000):
        for sdt, cdt in ((torch.float32, torch.float32),
                         (torch.float64, torch.float64),
                         (torch.bfloat16, torch.float32)):
            buf = torch.randn((2 * MSUB, n), device="cuda", dtype=cdt,
                              generator=gen).to(sdt)
            s = torch.randn(n, device="cuda", dtype=cdt, generator=gen)
            y = torch.randn(n, device="cuda", dtype=cdt, generator=gen)
            buf0 = buf.clone()
            for flag in (True, False):
                upd = torch.tensor(flag, device="cuda")
                ko, kd = kernels.qn_roll_update(buf, s, y, upd)
                po, pd = kernels.qn_roll_update_plain(buf, s, y, upd)
                name = str(sdt).split(".")[1]
                err = compare("qn_roll_update",
                              f"[{2 * MSUB}, {n}] {name} upd={flag}",
                              [kd], [pd], name, exact=[(ko, po)])
                check(torch.equal(buf, buf0), "qn_roll_update changed buf")
                if n == N_MAIN and sdt == torch.float32:
                    r = out.setdefault("qn_roll_update", {"max_abs_err": 0.0})
                    r["max_abs_err"] = max(r["max_abs_err"], err)
                if n == N_MAIN and sdt == torch.float32 and flag:
                    r["ms"] = cuda_ms(
                        torch, lambda: kernels.qn_roll_update(buf, s, y, upd))
                    r["plain_ms"] = cuda_ms(
                        torch,
                        lambda: kernels.qn_roll_update_plain(buf, s, y, upd))

    # 2./3. quasi_def_apply (K = 1 and 21) and phi_gram (B = 21)
    W_main = N_MAIN // BLOCK
    B = 2 * MSUB + 1
    for W in (W_main, 1000):
        for dt in (torch.float32, torch.float64):
            name = str(dt).split(".")[1]
            for K in (1, B):
                args = _qd_inputs(torch, gen, K, BLOCK, W, dt)
                got = kernels.quasi_def_apply(*args)
                want = kernels.quasi_def_apply_plain(*args)
                err = compare("quasi_def_apply",
                              f"K={K} k={BLOCK} nwcon={W} {name}", got, want,
                              name)
                if W == W_main and dt == torch.float32:
                    r = out.setdefault("quasi_def_apply",
                                       {"max_abs_err": 0.0})
                    r["max_abs_err"] = max(r["max_abs_err"], err)
                    ms = cuda_ms(torch, lambda: kernels.quasi_def_apply(*args))
                    pms = cuda_ms(
                        torch, lambda: kernels.quasi_def_apply_plain(*args))
                    log(f"[kernels] quasi_def_apply K={K} f32: "
                        f"{ms:.4f} ms kernel, {pms:.4f} ms plain")
                    if K == 1:  # the main path's step and init solves
                        r["ms"], r["plain_ms"] = ms, pms
            args = _qd_inputs(torch, gen, B, BLOCK, W, dt)
            got = kernels.phi_gram(*args)
            want = kernels.phi_gram_plain(*args)
            err = compare("phi_gram", f"B={B} k={BLOCK} nwcon={W} {name}",
                          got, want, name)
            if W == W_main and dt == torch.float32:
                out["phi_gram"] = {
                    "max_abs_err": err,
                    "ms": cuda_ms(torch, lambda: kernels.phi_gram(*args)),
                    "plain_ms": cuda_ms(
                        torch, lambda: kernels.phi_gram_plain(*args))}
    for name, r in out.items():
        log(f"[kernels] {name} main-path shape f32: {r['ms']:.4f} ms "
            f"kernel, {r['plain_ms']:.4f} ms plain")
    return out


def _build_solver(torch, n, dtype, device):
    from paropt_torch import ip_fused
    from paropt_torch.models.topology import SyntheticTopology
    from paropt_torch.ops import qn as qnmod
    prob = SyntheticTopology(n=n, block=BLOCK, dtype=dtype, device=device)
    opts = ip_fused.FusedIPOptions(use_quasi_newton_update=True,
                                   abs_res_tol=1e-6,
                                   iterative_refinement_steps=0)
    fused = ip_fused.FusedIP(ip_fused.model_from_problem(prob), prob.nvars,
                             prob.ncon, prob.nwcon, prob.nwblock, opts,
                             dtype=dtype)
    data, x0 = ip_fused.data_template_from_problem(prob, dtype=dtype)
    qn0 = qnmod.qn_init(MSUB, prob.nvars, dtype=dtype, device=device,
                        storage_dtype=qnmod.default_storage_dtype(dtype))
    return fused, data, x0, qn0


def phase_slice(torch):
    """The main path at n = 2^20 in float32; returns the launch counts."""
    from paropt_torch.ops import kernels
    fused, data, x0, qn0 = _build_solver(torch, N_MAIN, torch.float32,
                                         "cuda")
    warm = fused.solve(x0, data, (), qn0, None, max_iters=2)
    torch.cuda.synchronize()
    check(int(warm.k) == 2, "warm-up solve did not take 2 steps")
    fused.syncs.count = 0
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = fused.solve(x0, data, (), qn0, None)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    iters = int(state.k)
    fobj = float(state.fobj)
    res = float(state.res_norm)
    log(f"[slice] n={N_MAIN} f32 msub={MSUB}: converged="
        f"{bool(state.converged)} iters={iters} fobj={fobj:.9e} "
        f"res_norm={res:.3e} mu={float(state.mu):.3e}")
    log(f"[slice] wall {wall:.4f} s, {iters / wall:.2f} steps/s, "
        f"{fused.syncs.count / max(iters, 1):.2f} host syncs/step, "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"[slice] kernel launches in the solve: {launches}")
    check(bool(state.converged), f"solve did not converge (res {res:.3e})")
    check(res < 1e-6, f"res_norm {res:.3e} >= 1e-6")
    check(torch.isfinite(state.fobj).item(), "non-finite objective")
    check(state.vars.x.shape == (N_MAIN,)
          and torch.isfinite(state.vars.x).all().item(), "bad final x")
    for name, count in launches.items():
        check(count > 0, f"kernel {name} was not launched by the solve")
    return launches


def phase_crosscheck(torch):
    """n = 2^14 float64 on the card (kernels) against the host (plain)."""
    from paropt_torch.ops import kernels
    out = {}
    for device in ("cuda", "cpu"):
        kernels.reset_launches()
        fused, data, x0, qn0 = _build_solver(torch, 1 << 14, torch.float64,
                                             device)
        state = fused.solve(x0, data, (), qn0, None)
        out[device] = (int(state.k), float(state.fobj),
                       float(state.res_norm), bool(state.converged))
        log(f"[crosscheck] {device}: iters={out[device][0]} "
            f"fobj={out[device][1]:.15e} res={out[device][2]:.3e} "
            f"converged={out[device][3]} launches={dict(kernels.LAUNCHES)}")
    (kc, fc, _, cc), (kh, fh, _, ch) = out["cuda"], out["cpu"]
    check(cc and ch, "cross-check solve did not converge")
    check(kc == kh, f"iteration counts differ: cuda {kc}, cpu {kh}")
    check(abs(fc - fh) <= 1e-9 * abs(fh),
          f"objectives differ: cuda {fc!r}, cpu {fh!r}")


def main():
    import torch
    check((ROOT / "paropt_torch" / "csrc").is_dir(),
          f"paropt_torch not found beside {Path(__file__).name}")
    sys.path.insert(0, str(ROOT))
    phase_device(torch)
    phase_build()
    timing = phase_kernels(torch)
    launches = phase_slice(torch)
    phase_crosscheck(torch)
    rows = []
    for name, (source, replaces) in KERNELS.items():
        r = timing[name]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"]})
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
