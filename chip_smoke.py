#!/usr/bin/env python3
"""Smoke test of the paropt_torch port on one CUDA card.

    python3 chip_smoke.py

Phases (any failure raises and exits nonzero without the final line):

1. device: a CUDA card must be present; prints nvidia-smi's name and power
   limit, turns TF32 off and checks it;
2. build: compiles the CUDA kernels from paropt_torch/csrc with nvcc;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the main path's shapes and at ragged sizes (phi_gram as the factor setup
   calls it: the stack as two row blocks, bw = 0), and two runs of each
   quasi-definite kernel bitwise equal.  At the main path's shapes in
   float32: the device time of kernel and plain version (CUDA events,
   median of 20 runs after warm-up, L2 flushed), the bound (the bytes the
   function moves over 3.35 TB/s or its float32 operations over
   67 TFLOP/s, whichever is larger) and the share of it reached, with
   nvidia-smi's SM clock, power draw and power limit sampled after each;
   phi_gram must beat its unfused yardstick (quasi_def_apply at K = 21 plus
   torch.mm for the Gram matrix), timed beside it;
3b. kernels with the instance axis (k solves run as one): each kernel's
   instance-axis launch at kb = 4 over the main path's shapes in float32
   (the apply at K = 1 and phi_gram as the factor setup calls it, vals
   shared by the instances with stride 0) against the plain version
   batched, bit for bit against 4 single launches, and at kb = 1 bit for
   bit against the single launch; the device time of the instance-axis
   launch, of 4 single launches and of the plain version batched, and the
   bound (4 times the single call's bytes);
4. slice: the fused interior-point solve of SyntheticTopology at n = 2^20
   in float32 (in-loop L-BFGS, msub 10, abs_res_tol 1e-6, no refinement),
   which must converge and must launch every kernel;
5. cross-check: the same solve at n = 2^14 in float64 on the card (kernels)
   and on the host (plain versions) must agree in iteration count and
   objective;
6. MMA at full width: FusedMMA (default options, 10 outer iterations,
   cut from 20 to keep the whole script inside its time limit) on
   FEMTopology(768, 384, cg_iters=25, solver="mgcg"), 294,912 design
   variables and 592,130 dofs, in float32 and then in float64.  Each run
   prints its iterations, final fobj, infeasibility, l1, linf, seconds per
   outer iteration and peak memory, and one further outer iteration under
   torch.profiler: device kernels and busy share, split by the
   paropt.fem.solve, paropt.mma.eval and paropt.mma.inner_ip ranges.
   Checks: finite, fobj < 0.5 of the start, infeasibility < 1e-6, no host
   sync inside one FEM solve (torch.cuda.set_sync_debug_mode("error")),
   and no kernel of phase 3 on the path.  The relative residual
   ||K u - f|| / ||f|| of the final state solve must be < 1e-5 in float64;
   in float32 it is printed beside its floor, the residual of the float64
   solution rounded to float32 (~6e-4 at this mesh: no float32 solve can
   reach 1e-5 here), with the float32 compliance's error against float64;
7. the bench configuration: FusedMMA on FEMTopology(96, 48, cg_iters=25,
   solver="mgcg"), float32, 60 outer iterations; fobj must fall in
   bench.py's band (0.10, 0.18) with infeasibility < 1e-8;
8. card against host in float64: FusedMMA on FEMTopology(24, 12, mgcg,
   cg_iters 25) for 10 outer iterations and on DMOFEMTopology(12, 6,
   cg_iters 120) for 8 (cut from 20 and 15), once with CUDA tensors and
   once on the CPU: the
   same outer and inner iteration counts, fobj within 1e-9 relative;
9. TR at full width: FusedTR (bench.py's TR options: 20 outer iterations,
   abs_res_tol 1e-6, tr_infeas_tol 1e-5, tr_l1_tol 0, tr_linfty_tol 1e-5;
   L-BFGS msub 10) on SyntheticTopology(n = 2^20) in float32.  It must
   converge with infeasibility and linf below 1e-5, a finite x and fobj
   below its start, and must launch every kernel; it prints the outer and
   inner iterations, seconds and host reads per outer iteration, peak
   memory, and one further outer iteration under torch.profiler split by
   the paropt.tr.steer, paropt.tr.qp, paropt.tr.eval and
   paropt.tr.qn_update ranges;
10. bench.py's TR configuration: FusedTR on FEMTopology(48, 24,
   cg_iters=25, solver="mgcg"), float32, 20 outer iterations; fobj must
   fall in bench.py's band (0.18, 0.30) with infeasibility < 1e-6, and of
   the kernels only the outer QN update's may launch (nwcon = 0);
11. card against host in float64: FusedTR on SyntheticTopology(n = 2^14)
   and on FEMTopology(12, 6, mgcg, cg_iters 25), 6 outer iterations each
   (cut from 10),
   once with CUDA tensors and once on the CPU: the same outer and inner
   iteration counts, fobj within 1e-9 relative.

Phases 12-15 run the facade's default routes, the host loops
(`Optimizer(problem, options)` with ``use_fused_loop`` left unset), writing
their logs under build/:

12. host TR at full width: phase 9's problem and options through
   `Optimizer` (algorithm 'tr' by default).  It must converge with
   infeasibility and linf below 1e-5, a finite x and fobj below its start,
   take phase 9's outer iterations with fobj within 1e-5 relative of
   phase 9's, launch every kernel, and write a log that `unpack_tr_output`
   parses to one row per outer iteration; it prints the outer and inner
   iterations, seconds and host reads per outer iteration, peak memory and
   one further outer iteration under torch.profiler;
13. host IP at full width: `Optimizer(..., {"algorithm": "ip", ...})` on
   SyntheticTopology(n = 2^20) in float32 with phase 4's settings (L-BFGS
   msub 10, abs_res_tol 1e-6, no refinement).  It must converge below
   1e-6 (the reason is printed) and launch every kernel; it prints its
   iterations beside phase 4's, seconds and host reads per iteration, peak
   memory and one further iteration under torch.profiler;
14. host MMA against FusedMMA: both on FEMTopology(768, 384, cg_iters=25,
   solver="mgcg") in float64 for 3 outer iterations (cut from 5); fobj
   within 1e-9
   relative, x within 1e-7, the same inner iterations, no kernel launched;
15. card against host in float64: the host IP and TR on
   SyntheticTopology(n = 2^14) and the host MMA on FEMTopology(24, 12,
   mgcg), 10 outer iterations each (or to convergence), once with CUDA
   tensors and once on the CPU: the same iteration counts, fobj within
   1e-9 relative and equal integer columns in their logs.

Phases 16-20 run the Newton-Krylov (GMRES) phase and the 3-D voxel FEM:

16. NK at full width: SyntheticTopology(n = 2^20) in float32 through the
   host IP (`Optimizer`, phase 13's settings) and through FusedIP (phase
   4's settings), each with tests/test_gmres.py's NK options (Hessian-vector
   products, GMRES subspace 25, Eisenstat-Walker gamma 0.05, nk_switch_tol
   1e-3).  Each must converge below 1e-6, take at least one NK step and
   launch every kernel; each prints its iterations beside phases 4 and 13,
   NK steps, GMRES arms, Hessian-vector products, seconds and host reads
   per iteration, peak memory, launches, and one NK iteration under
   torch.profiler;
17. card against host in float64: the host IP and FusedIP with NK on
   SyntheticTopology(n = 2^14), once with CUDA tensors and once on the CPU:
   the same iterations and GMRES arms per iteration, fobj within 1e-9;
18. 3-D MMA at full width: FEMTopology3D(160, 80, 80, cg_iters=40,
   solver="mgcg"), 1,024,000 design variables and 3,168,963 dofs, in
   float32.  First K(E)·u on each multigrid level in both layouts (device
   ms by CUDA events, median of 20; wall ms per call; kernels per call) and
   the layout `auto` takes; then FusedMMA for 12 outer iterations (cut
   from the flagship's 60) with
   phase 6's prints and checks (fobj < 0.5 of the start, infeasibility
   < 1e-6, a sync-free state solve, no phase-3 kernel).  A float64 state
   solve at the final design must reach ||K u - f|| / ||f|| < 1e-5 (its
   cg_iters raised to 80 for that solve alone if 40 do not), and the
   float32 residual is printed beside its floor;
19. bench.py's 3-D configuration: FusedMMA on FEMTopology3D(32, 16, 16,
   cg_iters=25, solver="mgcg"), float32, 40 outer iterations; fobj must
   fall in bench.py's band (0.08, 0.14) with infeasibility < 1e-8;
20. card against host in float64 on FEMTopology3D(8, 4, 4, mgcg): FusedMMA
   and the host MMA through the facade (6 outer iterations each, cut from
   10; equal log columns iter and subiter) and FusedTR (3 outer
   iterations, cut from 5); FusedMMA (6, cut from 12) on DMOFEMTopology3D(6, 3, 3,
   cg_iters=250): the same counts, fobj within 1e-9 relative.

The line before the last is a JSON object with one entry per kernel (its
launches in the phase-4 IP solve, as tr_launches in the phase-9 TR solve,
as host_tr_launches and host_ip_launches in phases 12 and 13, and as
nk_launches in phase 16's host NK solve; its phase-3 error, times and
bound; library_ms is null, since no single PyTorch call computes any of
the three functions); the last line is {"ok": true, "device": {...}}.
Phases 21-25 run the batched solves (`solve_batched`: k solves as one,
every step's phases under torch.func.vmap, each kernel launched once per
call with its instance axis):

21. batched IP at full width: phase 4's problem and settings with k = 4
   starts (x0 scaled by default_rng(0).uniform(0.5, 1.5)), in float32 and
   in float64.  Every instance must converge below 1e-6 and every kernel
   launch must be an instance-axis launch.  float32: one batched step must
   launch each kernel as often as one single step; each instance is
   printed beside its own single solve and beside a single solve from its
   start moved by a relative 1e-7 (float32's roundoff floor: on this
   problem roundoff alone moves a float32 solve by iterations and by
   ~1e-4 in fobj, so float32 cannot hold one summation order to
   another's).  float64: each instance within one iteration of its own
   single solve and fobj within 1e-5 relative (the measured agreement,
   printed, is ~1e-13).  It prints the wall time,
   ms per batched step beside the single solves', host reads per step both
   ways, peak memory, launches, and one float32 batched step under
   torch.profiler;
22. scripts/bench_batched.py's defaults: n = 4096, k = 32, tol 1e-4,
   float32: the batched solve against 32 sequential single solves, wall
   time both ways and their ratio (recorded, not claimed); the same
   convergence flags and fobj within 1e-5;
23. batched MMA at full width: FEMTopology(768, 384, mgcg), k = 4 starts
   clipped to [0.05, 0.95] from uniform(0.6, 1.4).  float32, 10 outer
   iterations (a depth cut): infeasibility < 1e-6 for every instance, no
   kernel launched, instance 1 printed beside its single solve and the
   float32 floor.  float64, 3 outer iterations: instance 1 equal to its
   own single solve in niter and fobj (1e-5 relative);
24. batched TR with k = 4: phase 9's configuration (every instance
   converged, all three kernels launched, every launch with the instance
   axis, instance 2 equal to its single solve in niter and fobj within
   1e-5), and bench.py's FEM 48x24 as examples/fem_topology_tr.py runs it
   (only qn_roll_update): float32, 6 outer iterations, instance 2 printed
   beside its single solve and the float32 floor; float64, 4 outer
   iterations, instance 2 equal to its single solve (fobj within 1e-5);
25. card against host in float64: the three batched solves at the CPU
   tests' sizes (SyntheticTopology(256); FEM 8x4), depths cut (the IP to
   60 steps, the MMA and TR to 6 and 4 outer iterations), on the card and
   on the CPU: equal counts, fobj within 1e-12 relative per instance.

The kernels line also carries each kernel's launches in phase 21
(batched_launches) and in phase 24's n = 2^20 batch
(batched_tr_launches), and its phase-3b error and times.
Only torch and numpy are used.
"""

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
BUILD = ROOT / "build"

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
# the H100 SXM's published peaks (NVIDIA's data sheet): HBM3 bandwidth and
# float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
SPIN_CYCLES = 100_000_000    # ~50 ms at the H100's clock


def log(msg):
    print(msg, flush=True)


def check(cond, msg):
    if not cond:
        raise SystemExit(f"chip_smoke: FAIL: {msg}")


def cuda_ms(torch, fn, reps=20, warmup=3, clean=False):
    """Median device time of fn() in milliseconds over `reps` runs, each
    between a pair of CUDA events, with the L2 cache flushed before each run
    (an upper bound for a caller whose operands are partly in L2).  The
    flush writes 256 MB, so each run starts with the L2 full of dirty lines
    that its own traffic must write back; with `clean` it reads them
    instead, and each run starts with a clean L2.  A spin
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
            if clean:
                flush.sum()
            else:
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


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def bound_ms(nbytes, flops):
    """(least time in ms, what bounds it): the bytes the function must move
    over the memory rate, or its float32 operations over the float32 rate,
    whichever is larger."""
    mem = nbytes / HBM_BYTES_PER_S * 1e3
    ops = flops / F32_FLOPS_PER_S * 1e3
    return (mem, "bytes") if mem >= ops else (ops, "operations")


def smi_sample():
    """The card's SM clock, power draw and power limit, as nvidia-smi reads
    them now."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else \
        f"nvidia-smi failed: {smi.stderr.strip()}"


def phase_kernels(torch):
    """Each kernel against its plain version; returns per-kernel results at
    the main path's shapes in float32 (error, times, bound)."""
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

    def repeat_bitwise(name, label, fn, first):
        again = fn()
        check(all(torch.equal(a, b) for a, b in zip(first, again)),
              f"{name} {label}: two runs differ")
        log(f"[kernels] {name} {label}: two runs bitwise equal")

    def timed(name, label, fn, plain, nbytes, flops):
        ms = cuda_ms(torch, fn)
        pms = cuda_ms(torch, plain)
        smi = smi_sample()
        clean_ms = cuda_ms(torch, fn, clean=True)
        bms, by = bound_ms(nbytes, flops)
        log(f"[kernels] {name} {label}: {ms:.4f} ms kernel, {pms:.4f} ms "
            f"plain; bound {bms:.4f} ms by {by} ({nbytes / 1e6:.2f} MB, "
            f"{flops / 1e9:.3f} GFLOP), {100 * bms / ms:.1f}% of bound; "
            f"clocks.sm, power.draw, power.limit: {smi}; kernel after a "
            f"clean flush {clean_ms:.4f} ms ({100 * bms / clean_ms:.1f}%)")
        return {"ms": ms, "plain_ms": pms, "bound_ms": bms, "bound_by": by}

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
                    r.update(timed(
                        "qn_roll_update", f"[{2 * MSUB}, {n}] f32",
                        lambda: kernels.qn_roll_update(buf, s, y, upd),
                        lambda: kernels.qn_roll_update_plain(buf, s, y, upd),
                        _nbytes(buf, s, y, upd, ko, kd),
                        4 * 2 * MSUB * n))

    # 2. quasi_def_apply: K = 1 (every step solve) and K = 21
    W_main = N_MAIN // BLOCK
    B = 2 * MSUB + 1
    for W in (W_main, 1000, 1001):
        for dt in (torch.float32, torch.float64):
            name = str(dt).split(".")[1]
            for K in (1, B):
                args = _qd_inputs(torch, gen, K, BLOCK, W, dt)
                label = f"K={K} k={BLOCK} nwcon={W} {name}"
                got = kernels.quasi_def_apply(*args)
                err = compare("quasi_def_apply", label, got,
                              kernels.quasi_def_apply_plain(*args), name)
                repeat_bitwise("quasi_def_apply", label,
                               lambda: kernels.quasi_def_apply(*args), got)
                if W == W_main and dt == torch.float32:
                    r = out.setdefault("quasi_def_apply",
                                       {"max_abs_err": 0.0})
                    r["max_abs_err"] = max(r["max_abs_err"], err)
                    t = timed("quasi_def_apply", f"K={K} f32",
                              lambda: kernels.quasi_def_apply(*args),
                              lambda: kernels.quasi_def_apply_plain(*args),
                              _nbytes(*args, *got),
                              K * W * (6 * BLOCK + 2))
                    if K == 1:  # the main path's step and init solves
                        r.update(t)

    # 3. phi_gram, B = 21, as the factor setup calls it: the stack as its
    # Z_qn rows (2m) and A's row, bw = 0; and whole with a bw
    for W in (W_main, 1000, 1001):
        for dt in (torch.float32, torch.float64):
            name = str(dt).split(".")[1]
            dinv, cwinv, vals, bx, bw = _qd_inputs(torch, gen, B, BLOCK, W, dt)
            z, a = bx[:2 * MSUB], bx[2 * MSUB:]
            label = f"B={B} k={BLOCK} nwcon={W} {name}"
            got = kernels.phi_gram(dinv, cwinv, vals, z, None, a)
            err = compare("phi_gram", label, got,
                          kernels.phi_gram_plain(dinv, cwinv, vals, z, None,
                                                 a), name)
            repeat_bitwise("phi_gram", label, lambda: kernels.phi_gram(
                dinv, cwinv, vals, z, None, a), got)
            compare("phi_gram", label + " with bw",
                    kernels.phi_gram(dinv, cwinv, vals, bx, bw),
                    kernels.phi_gram_plain(dinv, cwinv, vals, bx, bw), name)
            if W == W_main and dt == torch.float32:
                bw0 = torch.zeros_like(bw)

                def unfused():
                    # the yardstick: the apply at K = 21, then the Gram
                    # matrix as one product (the port never calls this)
                    yx, yw = kernels.quasi_def_apply(dinv, cwinv, vals, bx,
                                                     bw0)
                    return yx, yw, bx.reshape(B, -1) @ yx.reshape(B, -1).T

                compare("phi_gram", label + " unfused yardstick", unfused(),
                        got, name)
                r = {"max_abs_err": err}
                r.update(timed(
                    "phi_gram", f"B={B} f32",
                    lambda: kernels.phi_gram(dinv, cwinv, vals, z, None, a),
                    lambda: kernels.phi_gram_plain(dinv, cwinv, vals, z,
                                                   None, a),
                    _nbytes(dinv, cwinv, vals, bx, *got),
                    2 * B * B * BLOCK * W + B * W * (6 * BLOCK + 2)))
                r["unfused_ms"] = cuda_ms(torch, unfused)
                log(f"[kernels] phi_gram B={B} f32: unfused yardstick "
                    f"(quasi_def_apply K={B} + torch.mm) "
                    f"{r['unfused_ms']:.4f} ms against {r['ms']:.4f} ms "
                    f"fused; clocks.sm, power.draw, power.limit: "
                    f"{smi_sample()}")
                check(r["ms"] < r["unfused_ms"],
                      f"phi_gram {r['ms']:.4f} ms is not faster than its "
                      f"unfused yardstick {r['unfused_ms']:.4f} ms")
                out["phi_gram"] = r
    for name, r in out.items():
        log(f"[kernels] {name} main-path shape f32: {r['ms']:.4f} ms "
            f"kernel, {r['plain_ms']:.4f} ms plain, bound {r['bound_ms']:.4f}"
            f" ms by {r['bound_by']} ({100 * r['bound_ms'] / r['ms']:.1f}%);"
            f" library call: none (no single PyTorch call computes it)")
    return out


def _build_solver(torch, n, dtype, device, **extra):
    from paropt_torch import ip_fused
    from paropt_torch.models.topology import SyntheticTopology
    from paropt_torch.ops import qn as qnmod
    prob = SyntheticTopology(n=n, block=BLOCK, dtype=dtype, device=device)
    opts = ip_fused.FusedIPOptions(**dict(
        dict(use_quasi_newton_update=True, abs_res_tol=1e-6,
             iterative_refinement_steps=0), **extra))
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
    torch.cuda.reset_peak_memory_stats()
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
    return launches, iters


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


def _mma_solver(torch, problem, iters, dtype_name):
    from paropt_torch.mma import FusedMMA
    return FusedMMA(problem, {"mma_max_iterations": iters,
                              "mma_output_file": None, "dtype": dtype_name})


MMA_RANGES = ("paropt.fem.solve", "paropt.mma.eval", "paropt.mma.inner_ip")
TR_RANGES = ("paropt.tr.steer", "paropt.tr.qp", "paropt.tr.eval",
             "paropt.tr.qn_update")


def _profile_outer_step(torch, solver, state, names=MMA_RANGES):
    """One outer iteration of a fused solver under torch.profiler."""
    return _profile_call(torch, lambda: solver._step(state), names)


def _profile_call(torch, fn, names=()):
    """``fn()`` under torch.profiler: the window, device ops, busy seconds
    of the window, and device ops / device ms / host ms inside each range
    of ``names``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    on_dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    ranges = [e for e in on_dev if e.name.startswith("paropt.")]
    ops = [e for e in on_dev if not e.name.startswith("paropt.")]
    busy = sum(e.time_range.elapsed_us() for e in ops) * 1e-6
    split = {}
    for name in names:
        inside = [k for r in ranges if r.name == name for k in ops
                  if r.time_range.start <= k.time_range.start
                  < r.time_range.end]
        host = sum(e.time_range.elapsed_us() for e in prof.events()
                   if e.device_type == DeviceType.CPU and e.name == name)
        split[name] = (len(inside),
                       sum(k.time_range.elapsed_us() for k in inside) * 1e-3,
                       host * 1e-3)
    return window, len(ops), busy, split


def _relres(torch, p64, E, u):
    """||K u - f|| / ||f||, evaluated in float64 by the float64 model p64
    (fixed dofs carry the identity)."""
    r = p64._kmul(E.double(), u.double()) - p64.f
    return (torch.linalg.norm(r) / torch.linalg.norm(p64.f)).item()


def phase_mma_full(torch, dtype, nex=768, ney=384, iters=20):
    """FusedMMA on the full-width FEM mesh; returns the final design."""
    from paropt_torch.models.fem_topology import FEMTopology
    from paropt_torch.ops import kernels
    tag = f"[mma {nex}x{ney} {str(dtype).split('.')[1]}]"
    t0 = time.perf_counter()
    prob = FEMTopology(nex, ney, cg_iters=25, solver="mgcg", dtype=dtype,
                       device="cuda")
    torch.cuda.synchronize()
    log(f"{tag} {prob.nvars} design variables, {prob.ndof} dofs, "
        f"{len(prob._mg_dims)} multigrid levels (coarsest "
        f"{prob._mg_dims[-1][0]}x{prob._mg_dims[-1][1]}, "
        f"{2 * (prob._mg_dims[-1][0] + 1) * (prob._mg_dims[-1][1] + 1)}-dof "
        f"Cholesky); built in {time.perf_counter() - t0:.2f} s")
    x0, _, _ = prob.get_vars_and_bounds()
    f0 = float(prob.objective(x0))
    # no host sync inside one state solve (CG and the V-cycle)
    E0 = prob._simp(prob._filter(x0))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        prob._solve(E0)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    log(f"{tag} one FEM solve ran under set_sync_debug_mode('error')")

    # warm-up: one outer iteration of a separate solver (library init)
    warm = _mma_solver(torch, prob, iters, str(dtype).split(".")[1])
    warm._step(warm._state0)
    solver = _mma_solver(torch, prob, iters, str(dtype).split(".")[1])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    res, state = solver.solve()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    niter, sub = res["niter"], int(state.subiters)
    log(f"{tag} outer iterations {niter}, inner IP iterations {sub}; "
        f"fobj {res['fobj']:.9e} (start {f0:.9e}), infeas "
        f"{res['infeas']:.3e}, l1 {res['l1']:.6e}, linf {res['linfty']:.6e}")
    log(f"{tag} wall {wall:.3f} s = {wall / max(niter, 1):.4f} s per outer "
        f"iteration ({solver.syncs.count} host reads); peak memory "
        f"{peak:.3f} GiB; phase-3 kernel launches {launches}")
    window, nops, busy, split = _profile_outer_step(torch, solver, state)
    log(f"{tag} one outer iteration under the profiler: {window:.3f} s, "
        f"{nops} device ops, device busy {busy:.4f} s = "
        f"{100 * busy / window:.1f}% (idle {100 * (1 - busy / window):.1f}%)")
    for name, (cnt, dev_ms, host_ms) in split.items():
        log(f"{tag}   {name}: {cnt} device ops, device {dev_ms:.3f} ms, "
            f"host {host_ms:.3f} ms")

    x = res["x"]
    E = prob._simp(prob._filter(x))
    u = prob._solve(E)
    p64 = prob if dtype == torch.float64 else FEMTopology(
        nex, ney, cg_iters=25, solver="mgcg", dtype=torch.float64,
        device="cuda")
    relres = _relres(torch, p64, E, u)
    check(torch.isfinite(x).all().item() and x.shape == (prob.nvars,),
          "bad final design")
    for key in ("fobj", "infeas", "l1", "linfty"):
        check(math.isfinite(res[key]), f"non-finite {key}")
    check(res["fobj"] < 0.5 * f0, f"fobj {res['fobj']:.4e} >= 0.5 of the "
          f"start {f0:.4e}")
    check(res["infeas"] < 1e-6, f"infeas {res['infeas']:.3e} >= 1e-6")
    check(not any(launches.values()),
          f"a phase-3 kernel ran on the MMA/FEM path: {launches}")
    if dtype == torch.float64:
        log(f"{tag} final state solve: relative residual {relres:.3e}")
        check(relres < 1e-5, f"CG relative residual {relres:.3e} >= 1e-5")
    else:
        u64 = p64._solve(E.double())
        floor = _relres(torch, p64, E, u64.float())
        c32 = float(prob.f @ u)
        c64 = float(p64.f @ u64)
        log(f"{tag} final state solve: relative residual {relres:.3e}; "
            f"float32 floor (float64 solution rounded) {floor:.3e}; "
            f"float64 solve {_relres(torch, p64, E, u64):.3e}; float32 "
            f"compliance {c32:.6e} vs float64 {c64:.6e} "
            f"(rel err {abs(c32 - c64) / abs(c64):.3e})")
    return x


def phase_mma_bench(torch):
    """bench.py's MMA configuration as a correctness check."""
    from paropt_torch.models.fem_topology import FEMTopology
    prob = FEMTopology(96, 48, cg_iters=25, solver="mgcg",
                       dtype=torch.float32, device="cuda")
    solver = _mma_solver(torch, prob, 60, "float32")
    t0 = time.perf_counter()
    res, state = solver.solve()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    log(f"[mma 96x48 float32] outer iterations {res['niter']}, inner "
        f"{int(state.subiters)}, fobj {res['fobj']:.6f}, infeas "
        f"{res['infeas']:.3e}, l1 {res['l1']:.4e}; {wall:.2f} s = "
        f"{wall / max(res['niter'], 1):.4f} s per outer iteration")
    check(0.10 < res["fobj"] < 0.18,
          f"fobj {res['fobj']:.4f} outside bench.py's band (0.10, 0.18)")
    check(res["infeas"] < 1e-8, f"infeas {res['infeas']:.3e} >= 1e-8")


def phase_mma_crosscheck(torch):
    """FEM and DMO in float64, card against host."""
    from paropt_torch.models.fem_topology import DMOFEMTopology, FEMTopology
    cases = (
        ("fem 24x12 mgcg", 10, lambda dev: FEMTopology(
            24, 12, cg_iters=25, solver="mgcg", dtype=torch.float64,
            device=dev)),
        ("dmo 12x6", 8, lambda dev: DMOFEMTopology(
            12, 6, cg_iters=120, dtype=torch.float64, device=dev)),
    )
    for name, iters, make in cases:
        out = {}
        for dev in ("cuda", "cpu"):
            t0 = time.perf_counter()
            res, state = _mma_solver(torch, make(dev), iters,
                                     "float64").solve()
            out[dev] = (res["niter"], int(state.subiters), res["fobj"])
            log(f"[mma crosscheck] {name} {dev}: outer {out[dev][0]}, inner "
                f"{out[dev][1]}, fobj {out[dev][2]:.15e} "
                f"({time.perf_counter() - t0:.2f} s)")
        (kc, sc, fc), (kh, sh, fh) = out["cuda"], out["cpu"]
        check(kc == kh and sc == sh,
              f"{name}: iteration counts differ: cuda {kc}/{sc}, "
              f"cpu {kh}/{sh}")
        check(abs(fc - fh) <= 1e-9 * abs(fh),
              f"{name}: objectives differ: cuda {fc!r}, cpu {fh!r}")


TR_OPTS = {"tr_output_file": None, "output_file": None,
           "tr_max_iterations": 20, "abs_res_tol": 1e-6,
           "tr_infeas_tol": 1e-5, "tr_l1_tol": 0.0, "tr_linfty_tol": 1e-5}


def _tr_solver(problem, dtype_name, **extra):
    from paropt_torch.tr import FusedTR
    return FusedTR(problem, dict(TR_OPTS, dtype=dtype_name, **extra))


def phase_tr_full(torch):
    """FusedTR on SyntheticTopology at n = 2^20 in float32; returns the
    kernel launch counts of the solve."""
    from paropt_torch.models.topology import SyntheticTopology
    from paropt_torch.ops import kernels
    tag = f"[tr n={N_MAIN} float32]"
    prob = SyntheticTopology(n=N_MAIN, block=BLOCK, dtype=torch.float32,
                             device="cuda")
    x0, _, _ = prob.get_vars_and_bounds()
    f0 = float(prob.objective(x0))
    warm = _tr_solver(prob, "float32")
    warm._step(warm._state0)
    solver = _tr_solver(prob, "float32")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    res, state = solver.solve()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    niter, sub = res["niter"], res["subiters"]
    log(f"{tag} converged={res['converged']} outer iterations {niter}, "
        f"inner IP iterations {sub}; fobj {res['fobj']:.9e} (start "
        f"{f0:.9e}), infeas {res['infeas']:.3e}, l1 {res['l1']:.6e}, "
        f"linf {res['linfty']:.6e}, tr_size {res['tr_size']:.4e}")
    log(f"{tag} wall {wall:.4f} s = {wall / max(niter, 1):.4f} s per outer "
        f"iteration, {wall / max(sub, 1) * 1e3:.2f} ms per inner step; "
        f"{solver.syncs.count} host reads = "
        f"{solver.syncs.count / max(niter, 1):.1f} per outer iteration; "
        f"peak memory {peak:.3f} GiB; kernel launches {launches}")
    window, nops, busy, split = _profile_outer_step(torch, solver, state,
                                                    TR_RANGES)
    log(f"{tag} one outer iteration under the profiler: {window:.3f} s, "
        f"{nops} device ops, device busy {busy:.4f} s = "
        f"{100 * busy / window:.1f}% (idle {100 * (1 - busy / window):.1f}%)")
    for name, (cnt, dev_ms, host_ms) in split.items():
        log(f"{tag}   {name}: {cnt} device ops, device {dev_ms:.3f} ms, "
            f"host {host_ms:.3f} ms")
    x = res["x"]
    check(x.shape == (N_MAIN,) and torch.isfinite(x).all().item(),
          "bad final x")
    check(res["converged"], f"TR did not converge in {niter} outer "
          f"iterations (infeas {res['infeas']:.3e}, linf "
          f"{res['linfty']:.3e})")
    check(res["infeas"] < 1e-5 and res["linfty"] < 1e-5,
          f"infeas {res['infeas']:.3e} or linf {res['linfty']:.3e} >= 1e-5")
    check(math.isfinite(res["fobj"]) and res["fobj"] < f0,
          f"fobj {res['fobj']:.6e} not below the start {f0:.6e}")
    for name, count in launches.items():
        check(count > 0, f"kernel {name} was not launched by the TR solve")
    return launches, niter, res["fobj"]


def phase_tr_bench(torch):
    """bench.py's TR configuration as a correctness check."""
    from paropt_torch.models.fem_topology import FEMTopology
    from paropt_torch.ops import kernels
    prob = FEMTopology(48, 24, cg_iters=25, solver="mgcg",
                       dtype=torch.float32, device="cuda")
    solver = _tr_solver(prob, "float32")
    kernels.reset_launches()
    t0 = time.perf_counter()
    res, state = solver.solve()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    log(f"[tr 48x24 float32] outer iterations {res['niter']}, inner "
        f"{res['subiters']}, fobj {res['fobj']:.6f}, infeas "
        f"{res['infeas']:.3e}, l1 {res['l1']:.4e}, linf "
        f"{res['linfty']:.4e}; {wall:.2f} s = "
        f"{wall / max(res['niter'], 1):.4f} s per outer iteration, "
        f"{res['niter'] / wall:.3f} outer iterations/s; launches {launches}")
    check(0.18 < res["fobj"] < 0.30,
          f"fobj {res['fobj']:.4f} outside bench.py's band (0.18, 0.30)")
    check(res["infeas"] < 1e-6, f"infeas {res['infeas']:.3e} >= 1e-6")
    check(launches["qn_roll_update"] == res["niter"]
          and launches["quasi_def_apply"] == launches["phi_gram"] == 0,
          f"unexpected kernel launches on the FEM TR path: {launches}")


def phase_tr_crosscheck(torch):
    """FusedTR in float64, card against host."""
    from paropt_torch.models.fem_topology import FEMTopology
    from paropt_torch.models.topology import SyntheticTopology
    cases = (
        ("synthetic n=2^14", lambda dev: SyntheticTopology(
            n=1 << 14, block=BLOCK, dtype=torch.float64, device=dev)),
        ("fem 12x6 mgcg", lambda dev: FEMTopology(
            12, 6, cg_iters=25, solver="mgcg", dtype=torch.float64,
            device=dev)),
    )
    for name, make in cases:
        out = {}
        for dev in ("cuda", "cpu"):
            t0 = time.perf_counter()
            res, _ = _tr_solver(make(dev), "float64",
                                tr_max_iterations=6).solve()
            out[dev] = (res["niter"], res["subiters"], res["fobj"])
            log(f"[tr crosscheck] {name} {dev}: outer {out[dev][0]}, inner "
                f"{out[dev][1]}, fobj {out[dev][2]:.15e}, converged "
                f"{res['converged']} ({time.perf_counter() - t0:.2f} s)")
        (kc, sc, fc), (kh, sh, fh) = out["cuda"], out["cpu"]
        check(kc == kh and sc == sh,
              f"{name}: iteration counts differ: cuda {kc}/{sc}, "
              f"cpu {kh}/{sh}")
        check(abs(fc - fh) <= 1e-9 * abs(fh),
              f"{name}: objectives differ: cuda {fc!r}, cpu {fh!r}")


def _log_busy(tag, what, window, nops, busy):
    log(f"{tag} {what} under the profiler: {window:.3f} s, {nops} device "
        f"ops, device busy {busy:.4f} s = {100 * busy / window:.1f}% (idle "
        f"{100 * (1 - busy / window):.1f}%)")


def _host_route(torch, problem, options, log_name=None):
    """`Optimizer(problem, options).optimize()` with the log (if named)
    under build/, timed, with the kernel launches, peak memory and host
    reads of the run.  Returns (optimizer, result, wall, launches, peak,
    log path)."""
    from paropt_torch import Optimizer
    from paropt_torch.ops import kernels
    path = None
    options = dict(options, output_file=None, tr_output_file=None,
                   mma_output_file=None)
    if log_name is not None:
        BUILD.mkdir(exist_ok=True)
        path = BUILD / log_name
        key = {"ip": "output_file", "tr": "tr_output_file",
               "mma": "mma_output_file"}[options.get("algorithm", "tr")]
        options[key] = str(path)
    opt = Optimizer(problem, options)
    check(opt.options["use_fused_loop"] is False,
          "the facade's default route must be the host loop")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = opt.optimize()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return (opt, res, wall, dict(kernels.LAUNCHES),
            torch.cuda.max_memory_allocated() / 2**30, path)


def phase_host_tr_full(torch, fused_niter, fused_fobj):
    """The host TrustRegion, the facade's default, at n = 2^20 in float32;
    returns the kernel launch counts of the solve."""
    from paropt_torch.models.topology import SyntheticTopology
    from paropt_torch.utils.logging import unpack_tr_output
    tag = f"[host tr n={N_MAIN} float32]"
    prob = SyntheticTopology(n=N_MAIN, block=BLOCK, dtype=torch.float32,
                             device="cuda")
    x0, _, _ = prob.get_vars_and_bounds()
    f0 = float(prob.objective(x0))
    opts = dict(TR_OPTS, dtype="float32", qn_subspace_size=MSUB)
    opt, res, wall, launches, peak, path = _host_route(
        torch, prob, opts, "chip_smoke_host.tr")
    tr = opt._inner
    check(type(tr).__name__ == "TrustRegion", "not the host TrustRegion")
    niter, reads = res["niter"], tr.syncs.count
    log(f"{tag} converged={res['converged']} outer iterations {niter} "
        f"(phase 9: {fused_niter}), inner IP iterations {tr.inner_iters}; "
        f"fobj {res['fobj']:.9e} (phase 9 {fused_fobj:.9e}, start "
        f"{f0:.9e}), infeas {res['infeas']:.3e}, l1 {res['l1']:.6e}, linf "
        f"{res['linfty']:.6e}")
    log(f"{tag} wall {wall:.4f} s = {wall / max(niter, 1):.4f} s per outer "
        f"iteration, {wall / max(tr.inner_iters, 1) * 1e3:.2f} ms per inner "
        f"step; {reads} host reads = {reads / max(niter, 1):.1f} per outer "
        f"iteration; peak memory {peak:.3f} GiB; kernel launches {launches}")
    rows = unpack_tr_output(str(path))
    log(f"{tag} {path.name}: {len(rows['iter'])} rows, iter "
        f"{rows['iter'].astype(int).tolist()}")
    # one further outer iteration from the converged point
    tr.options["tr_max_iterations"] = 1
    tr.options["tr_output_file"] = None
    window, nops, busy, _ = _profile_call(torch, tr.optimize)
    _log_busy(tag, "one further outer iteration", window, nops, busy)
    x = res["x"]
    check(x.shape == (N_MAIN,) and torch.isfinite(x).all().item(),
          "bad final x")
    check(res["converged"] and res["infeas"] < 1e-5 and res["linfty"] < 1e-5,
          f"host TR did not converge: infeas {res['infeas']:.3e}, linf "
          f"{res['linfty']:.3e}")
    check(math.isfinite(res["fobj"]) and res["fobj"] < f0,
          f"fobj {res['fobj']:.6e} not below the start {f0:.6e}")
    check(niter == fused_niter, f"outer iterations {niter} != phase 9's "
          f"{fused_niter}")
    check(abs(res["fobj"] - fused_fobj) <= 1e-5 * abs(fused_fobj),
          f"fobj {res['fobj']!r} differs from phase 9's {fused_fobj!r}")
    check(rows["iter"].astype(int).tolist() == list(range(niter)),
          f"{path.name} does not hold one row per outer iteration")
    for name, count in launches.items():
        check(count > 0, f"kernel {name} was not launched by the host TR")
    return launches


def phase_host_ip_full(torch, fused_iters):
    """The host InteriorPoint at n = 2^20 in float32 with phase 4's
    settings; returns the kernel launch counts of the solve."""
    from paropt_torch.models.topology import SyntheticTopology
    from paropt_torch.utils.logging import unpack_output
    tag = f"[host ip n={N_MAIN} float32]"
    prob = SyntheticTopology(n=N_MAIN, block=BLOCK, dtype=torch.float32,
                             device="cuda")
    opts = {"algorithm": "ip", "dtype": "float32", "qn_subspace_size": MSUB,
            "abs_res_tol": 1e-6, "iterative_refinement_steps": 0}
    opt, res, wall, launches, peak, path = _host_route(
        torch, prob, opts, "chip_smoke_host.out")
    ip = opt._inner
    niter, reads = res["niter"], ip.syncs.count
    log(f"{tag} converged={res['converged']} reason={res['reason']!r} "
        f"iterations {niter} (phase 4 FusedIP: {fused_iters}); fobj "
        f"{res['fobj']:.9e}, res_norm {res['res_norm']:.3e}, mu "
        f"{res['mu']:.3e}")
    log(f"{tag} wall {wall:.4f} s = {wall / max(niter, 1) * 1e3:.2f} ms per "
        f"iteration; {reads} host reads = {reads / max(niter, 1):.1f} per "
        f"iteration; peak memory {peak:.3f} GiB; kernel launches {launches}")
    rows = unpack_output(str(path))
    log(f"{tag} {path.name}: {len(rows['iter'])} rows")
    # one further iteration from the converged point
    ip.options["starting_point_strategy"] = "no_start_strategy"
    ip.options["max_major_iters"] = 1
    ip.options["output_file"] = None
    window, nops, busy, _ = _profile_call(torch, ip.optimize)
    _log_busy(tag, "one further iteration", window, nops, busy)
    check(res["converged"] and res["res_norm"] < 1e-6,
          f"host IP did not converge below 1e-6: {res['reason']!r}, "
          f"res_norm {res['res_norm']:.3e}")
    check(torch.isfinite(res["x"]).all().item(), "bad final x")
    check(rows["iter"].astype(int).tolist() == list(range(niter + 1)),
          f"{path.name} does not hold one row per iteration")
    for name, count in launches.items():
        check(count > 0, f"kernel {name} was not launched by the host IP")
    return launches, niter


def phase_host_mma(torch):
    """The host MMA against FusedMMA at 768x384 in float64."""
    from paropt_torch.mma import FusedMMA
    from paropt_torch.models.fem_topology import FEMTopology
    tag = "[host mma 768x384 float64]"
    prob = FEMTopology(768, 384, cg_iters=25, solver="mgcg",
                       dtype=torch.float64, device="cuda")
    opts = {"algorithm": "mma", "mma_max_iterations": 3, "dtype": "float64"}
    opt, res, wall, launches, peak, _ = _host_route(
        torch, prob, opts, "chip_smoke_host.mma")
    mma = opt._inner
    t0 = time.perf_counter()
    fres, fstate = FusedMMA(prob, dict(opts, mma_output_file=None)).solve()
    torch.cuda.synchronize()
    fwall = time.perf_counter() - t0
    dx = (res["x"] - fres["x"]).abs().max().item()
    log(f"{tag} host: {mma.mma_iter - 1} outer / {mma.subproblem_iter} inner "
        f"iterations, fobj {res['fobj']:.15e}, {wall:.3f} s "
        f"({mma.syncs.count} host reads); FusedMMA: {fres['niter']} / "
        f"{int(fstate.subiters)}, fobj {fres['fobj']:.15e}, {fwall:.3f} s; "
        f"max |x - x_fused| {dx:.3e}; launches {launches}")
    check(mma.mma_iter - 1 == fres["niter"]
          and mma.subproblem_iter == int(fstate.subiters),
          "host and fused MMA iteration counts differ")
    check(abs(res["fobj"] - fres["fobj"]) <= 1e-9 * abs(fres["fobj"]),
          f"fobj differs: host {res['fobj']!r}, fused {fres['fobj']!r}")
    check(dx <= 1e-7, f"x differs by {dx:.3e}")
    check(not any(launches.values()),
          f"a kernel ran on the host MMA/FEM path: {launches}")


def phase_host_crosscheck(torch):
    """The host loops in float64, card against host."""
    from paropt_torch.models.fem_topology import FEMTopology
    from paropt_torch.models.topology import SyntheticTopology
    from paropt_torch.utils import logging as plog

    def syn(dev):
        return SyntheticTopology(n=1 << 14, block=BLOCK, dtype=torch.float64,
                                 device=dev)

    cases = (
        ("ip", syn, {"algorithm": "ip", "max_major_iters": 10},
         plog.unpack_output, ("iter", "nobj", "ngrd", "nhvc")),
        ("tr", syn, dict(TR_OPTS, tr_max_iterations=10),
         plog.unpack_tr_output, ("iter",)),
        ("mma", lambda dev: FEMTopology(24, 12, cg_iters=25, solver="mgcg",
                                        dtype=torch.float64, device=dev),
         {"algorithm": "mma", "mma_max_iterations": 10},
         plog.unpack_mma_output, ("iter", "subiter")),
    )
    for name, make, opts, unpack, int_cols in cases:
        out = {}
        for dev in ("cuda", "cpu"):
            t0 = time.perf_counter()
            opt, res, _, _, _, path = _host_route(
                torch, make(dev), dict(opts, dtype="float64"),
                f"chip_smoke_cross_{name}_{dev}.log")
            rows = unpack(str(path))
            out[dev] = (res["niter"], res["fobj"],
                        [rows[c].astype(int).tolist() for c in int_cols])
            log(f"[host crosscheck] {name} {dev}: niter {res['niter']}, fobj "
                f"{res['fobj']:.15e}, converged {res['converged']}, "
                f"{len(rows['iter'])} log rows "
                f"({time.perf_counter() - t0:.2f} s)")
        (kc, fc, ic), (kh, fh, ih) = out["cuda"], out["cpu"]
        check(kc == kh, f"{name}: iteration counts differ: cuda {kc}, "
              f"cpu {kh}")
        check(abs(fc - fh) <= 1e-9 * abs(fh),
              f"{name}: objectives differ: cuda {fc!r}, cpu {fh!r}")
        check(ic == ih, f"{name}: integer log columns differ")


NK_OPTS = {"use_hvec_product": True, "gmres_subspace_size": 25,
           "eisenstat_walker_gamma": 0.05, "nk_switch_tol": 1e-3}


def _nk_arms(path):
    """The GMRES arms each iteration row of an IP log reports (its
    ``iNK{n}`` flag; 0 for a quasi-Newton step)."""
    arms = []
    with open(path) as fp:
        for line in fp:
            parts = line.split()
            if len(parts) >= 15 and parts[0].isdigit():
                flags = [p for p in parts[15:] if p.startswith("iNK")]
                arms.append(int(flags[0][3:]) if flags else 0)
    return arms


def phase_nk_full(torch, fused_iters, host_iters):
    """Phase 16: the Newton-Krylov phase at n = 2^20 in float32, through
    the facade's host IP and through FusedIP; returns the kernel launch
    counts of the host solve."""
    from paropt_torch.ops import kernels
    from paropt_torch.models.topology import SyntheticTopology
    tag = f"[nk n={N_MAIN} float32]"
    # the host IP, phase 13's settings with the NK options
    prob = SyntheticTopology(n=N_MAIN, block=BLOCK, dtype=torch.float32,
                             device="cuda")
    opts = dict(NK_OPTS, algorithm="ip", dtype="float32",
                qn_subspace_size=MSUB, abs_res_tol=1e-6,
                iterative_refinement_steps=0)
    # warm-up: torch.func's first Hessian-vector product starts its
    # machinery once per process
    x0, _, _ = prob.get_vars_and_bounds()
    zw = torch.zeros(prob.nwcon, dtype=torch.float32, device="cuda")
    t0 = time.perf_counter()
    prob.eval_hvec_product(x0, zw[:1], zw, x0)
    torch.cuda.synchronize()
    log(f"{tag} first Hessian-vector product (warm-up): "
        f"{time.perf_counter() - t0:.3f} s")
    opt, res, wall, launches, peak, path = _host_route(
        torch, prob, opts, "chip_smoke_nk.out")
    ip = opt._inner
    niter, reads = res["niter"], ip.syncs.count
    arms = _nk_arms(path)
    used = [a for a in arms if a]
    log(f"{tag} host IP: converged={res['converged']} reason="
        f"{res['reason']!r} iterations {niter} (phase 4 FusedIP "
        f"{fused_iters}, phase 13 host IP {host_iters}); NK steps "
        f"{len(used)}, GMRES arms used {sum(used)} {used}, run (= hvp "
        f"count) {ip.nhvec}; fobj {res['fobj']:.9e}, res_norm "
        f"{res['res_norm']:.3e}")
    log(f"{tag} host IP: wall {wall:.4f} s = {wall / max(niter, 1):.4f} s "
        f"per iteration; {reads} host reads = {reads / max(niter, 1):.1f} "
        f"per iteration; peak memory {peak:.3f} GiB; kernel launches "
        f"{launches}")
    check(res["converged"] and res["res_norm"] < 1e-6,
          f"host NK solve did not converge below 1e-6: {res['reason']!r}, "
          f"res_norm {res['res_norm']:.3e}")
    check(ip.nhvec > 0, "the host IP took no Newton-Krylov step")
    for name, count in launches.items():
        check(count > 0, f"kernel {name} was not launched by the host NK "
              f"solve")
    # one further iteration from the converged point: NK engages there
    ip.options["starting_point_strategy"] = "no_start_strategy"
    ip.options["max_major_iters"] = 1
    ip.options["output_file"] = None
    before = ip.nhvec
    window, nops, busy, _ = _profile_call(torch, ip.optimize)
    _log_busy(tag, f"host IP: one further iteration ({ip.nhvec - before} "
              "GMRES arms)", window, nops, busy)

    # FusedIP, phase 4's settings with the NK options
    fused, data, x0, qn0 = _build_solver(torch, N_MAIN, torch.float32,
                                         "cuda", **NK_OPTS)
    steps = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    state = fused.solve(x0, data, (), qn0, None,
                        on_chunk=lambda st: steps.append(st.gmres_iters))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    flaunches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    iters = int(state.k)
    arms = [int(a) for a in steps]
    ran = [a for a in arms if a]
    log(f"{tag} FusedIP: converged={bool(state.converged)} iterations "
        f"{iters} (phase 4 {fused_iters}); NK steps {len(ran)}, GMRES arms "
        f"{sum(ran)} {ran} (the unroll runs {fused.opts.gmres_subspace_size}"
        f" per NK step, the arms counted are those before convergence); "
        f"fobj {float(state.fobj):.9e}, res_norm "
        f"{float(state.res_norm):.3e}")
    log(f"{tag} FusedIP: wall {wall:.4f} s = {wall / max(iters, 1):.4f} s "
        f"per iteration; {fused.syncs.count} host reads = "
        f"{fused.syncs.count / max(iters, 1):.2f} per iteration; peak "
        f"memory {peak:.3f} GiB; kernel launches {flaunches}")
    check(bool(state.converged) and float(state.res_norm) < 1e-6,
          f"FusedIP NK solve did not converge (res "
          f"{float(state.res_norm):.3e})")
    check(ran, "FusedIP took no Newton-Krylov step")
    for name, count in flaunches.items():
        check(count > 0, f"kernel {name} was not launched by the FusedIP NK "
              f"solve")
    # one NK step under the profiler: step again to the first NK step
    first = arms.index(ran[0])
    st = fused.init(x0, data, (), qn0, None)
    for _ in range(first):
        st = fused.step(st, data, (), None)
    window, nops, busy, split = _profile_call(
        torch, lambda: fused.step(st, data, (), None),
        ("paropt.kkt_factor", "paropt.kkt_solve_nk", "paropt.eval"))
    _log_busy(tag, f"FusedIP: NK step {first}", window, nops, busy)
    for name, (cnt, dev_ms, host_ms) in split.items():
        log(f"{tag}   {name}: {cnt} device ops, device {dev_ms:.3f} ms, "
            f"host {host_ms:.3f} ms")
    return launches


def phase_nk_crosscheck(torch):
    """Phase 17: the host IP and FusedIP with NK at n = 2^14 in float64,
    card against host."""
    from paropt_torch.models.topology import SyntheticTopology
    out = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        prob = SyntheticTopology(n=1 << 14, block=BLOCK,
                                 dtype=torch.float64, device=dev)
        opt, res, _, _, _, path = _host_route(
            torch, prob, dict(NK_OPTS, algorithm="ip", dtype="float64",
                              abs_res_tol=1e-6, max_major_iters=60),
            f"chip_smoke_nk_{dev}.out")
        fused, data, x0, qn0 = _build_solver(torch, 1 << 14, torch.float64,
                                             dev, **NK_OPTS)
        steps = []
        state = fused.solve(x0, data, (), qn0, None,
                            on_chunk=lambda st: steps.append(
                                int(st.gmres_iters)))
        out[dev] = (res["niter"], _nk_arms(path), opt._inner.nhvec,
                    res["fobj"], int(state.k), steps, float(state.fobj))
        log(f"[nk crosscheck] {dev}: host IP {res['niter']} iterations, "
            f"arms {[a for a in out[dev][1] if a]}, hvp {out[dev][2]}, fobj "
            f"{res['fobj']:.15e}; FusedIP {int(state.k)} steps, arms "
            f"{[a for a in steps if a]}, fobj {float(state.fobj):.15e} "
            f"({time.perf_counter() - t0:.2f} s)")
        check(res["converged"] and bool(state.converged),
              f"{dev}: an NK cross-check solve did not converge")
        check(opt._inner.nhvec > 0 and any(steps),
              f"{dev}: NK did not engage")
    c, h = out["cuda"], out["cpu"]
    check(c[:3] == h[:3], f"host IP: iterations or GMRES arms differ: cuda "
          f"{c[:3]}, cpu {h[:3]}")
    check(c[4:6] == h[4:6], f"FusedIP: steps or GMRES arms differ: cuda "
          f"{c[4:6]}, cpu {h[4:6]}")
    for i in (3, 6):
        check(abs(c[i] - h[i]) <= 1e-9 * abs(h[i]),
              f"objectives differ: cuda {c[i]!r}, cpu {h[i]!r}")


MESH3D = (160, 80, 80)


def _kernels_per_call(torch, fn, reps=20):
    """The device kernels one call of ``fn`` launches.  The profiler can
    drop the first device events of a window, so ``fn`` runs 2·reps times
    in one window with a spin kernel between the halves, and the kernels
    after the spin are counted."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda._sleep(1000)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    dev = sorted((e for e in prof.events()
                  if e.device_type == DeviceType.CUDA
                  and not e.name.startswith("paropt.")),
                 key=lambda e: e.time_range.start)
    spins = [i for i, e in enumerate(dev) if "spin" in e.name]
    check(spins, "the profiler recorded no spin kernel")
    return (len(dev) - spins[-1] - 1) / reps


def _time_layouts(torch, prob):
    """K(E)·u per multigrid level in both layouts at the starting design:
    device ms (CUDA events, median of 20), wall ms per call (host clock
    over 20 calls ending in a synchronise: the launches included) and
    device kernels per call, with the layout `auto` takes."""
    from paropt_torch.models import fem_topology3d as f3
    x0, _, _ = prob.get_vars_and_bounds()
    levels, _ = prob._mg_setup(
        prob._simp(prob._filter(x0)).reshape(prob.nex, prob.ney, prob.nez))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    for li, (Eg, _, fixed, cx, cy, cz) in enumerate(levels):
        ug = torch.randn((3, cx + 1, cy + 1, cz + 1), device="cuda",
                         dtype=Eg.dtype, generator=gen)
        fns = {"grid": lambda: f3._kmul_grid(prob.KE, Eg, ug, fixed, True),
               "aos": lambda: f3._kmul_aos(prob.KE, Eg, ug, fixed, True)}
        _, rel = rel_err(torch, fns["grid"](), fns["aos"]())
        check(rel < 1e-5, f"level {li}: the layouts differ by {rel:.3e}")
        row = {"auto": "grid" if prob._use_grid(cz + 1) else "aos"}
        for name, fn in fns.items():
            dev_ms = cuda_ms(torch, fn)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) / 20 * 1e3
            row[name] = (dev_ms, wall_ms, _kernels_per_call(torch, fn))
        log(f"[mma3d layouts] level {li} {cx}x{cy}x{cz} (nnz {cz + 1}): "
            f"grid {row['grid'][0]:.4f} ms device / {row['grid'][1]:.4f} ms "
            f"wall / {row['grid'][2]:g} kernels; aos {row['aos'][0]:.4f} ms "
            f"device / {row['aos'][1]:.4f} ms wall / {row['aos'][2]:g} "
            f"kernels; auto takes {row['auto']}; layouts agree to "
            f"{rel:.1e}")
    log(f"[mma3d layouts] clocks.sm, power.draw, power.limit: "
        f"{smi_sample()}")


MMA3D_ITERS = 12  # phase 18's depth, cut from the flagship's 60


def phase_mma3d_full(torch):
    """Phase 18: FusedMMA on the JAX package's 1M-voxel flagship mesh in
    float32, MMA3D_ITERS outer iterations."""
    from paropt_torch.models.fem_topology3d import FEMTopology3D
    from paropt_torch.ops import kernels
    tag = "[mma3d {}x{}x{} float32]".format(*MESH3D)
    t0 = time.perf_counter()
    prob = FEMTopology3D(*MESH3D, cg_iters=40, solver="mgcg",
                         dtype=torch.float32, device="cuda")
    torch.cuda.synchronize()
    cx, cy, cz = prob._mg_dims[-1]
    log(f"{tag} {prob.nvars} design variables, {prob.ndof} dofs, "
        f"{len(prob._mg_dims)} multigrid levels (coarsest {cx}x{cy}x{cz}, "
        f"{3 * (cx + 1) * (cy + 1) * (cz + 1)}-dof Cholesky); built in "
        f"{time.perf_counter() - t0:.2f} s")
    t1 = time.perf_counter()
    _time_layouts(torch, prob)
    log(f"{tag} layouts timed in {time.perf_counter() - t1:.2f} s")
    x0, _, _ = prob.get_vars_and_bounds()
    f0 = float(prob.objective(x0))
    E0 = prob._simp(prob._filter(x0))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        prob._solve(E0)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    log(f"{tag} one state solve ran under set_sync_debug_mode('error')")

    t1 = time.perf_counter()
    warm = _mma_solver(torch, prob, MMA3D_ITERS, "float32")
    warm._step(warm._state0)
    torch.cuda.synchronize()
    log(f"{tag} warm-up outer iteration {time.perf_counter() - t1:.2f} s")
    solver = _mma_solver(torch, prob, MMA3D_ITERS, "float32")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    res, state = solver.solve()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    niter, sub = res["niter"], int(state.subiters)
    log(f"{tag} outer iterations {niter}, inner IP iterations {sub}; "
        f"fobj {res['fobj']:.9e} (start {f0:.9e}), infeas "
        f"{res['infeas']:.3e}, l1 {res['l1']:.6e}, linf {res['linfty']:.6e}")
    log(f"{tag} wall {wall:.3f} s = {wall / max(niter, 1):.4f} s per outer "
        f"iteration ({solver.syncs.count} host reads); peak memory "
        f"{peak:.3f} GiB; phase-3 kernel launches {launches}")
    window, nops, busy, split = _profile_outer_step(torch, solver, state)
    _log_busy(tag, "one outer iteration", window, nops, busy)
    for name, (cnt, dev_ms, host_ms) in split.items():
        log(f"{tag}   {name}: {cnt} device ops, device {dev_ms:.3f} ms, "
            f"host {host_ms:.3f} ms")

    x = res["x"]
    check(torch.isfinite(x).all().item() and x.shape == (prob.nvars,),
          "bad final design")
    for key in ("fobj", "infeas", "l1", "linfty"):
        check(math.isfinite(res[key]), f"non-finite {key}")
    check(res["fobj"] < 0.5 * f0, f"fobj {res['fobj']:.4e} >= 0.5 of the "
          f"start {f0:.4e}")
    check(res["infeas"] < 1e-6, f"infeas {res['infeas']:.3e} >= 1e-6")
    check(not any(launches.values()),
          f"a phase-3 kernel ran on the 3-D MMA path: {launches}")
    # the state solve at the final design, checked in float64
    t1 = time.perf_counter()
    E = prob._simp(prob._filter(x))
    u32 = prob._solve(E)
    del solver, warm, state
    p64 = FEMTopology3D(*MESH3D, cg_iters=40, solver="mgcg",
                        dtype=torch.float64, device="cuda")
    u64 = p64._solve(E.double())
    torch.cuda.synchronize()
    log(f"{tag} float64 model and check solve {time.perf_counter() - t1:.2f}"
        f" s")
    relres = _relres(torch, p64, E, u64)
    log(f"{tag} float64 state solve at the final design, cg_iters 40: "
        f"relative residual {relres:.3e}")
    if relres >= 1e-5:
        p64.cg_iters = 80
        u64 = p64._solve(E.double())
        relres = _relres(torch, p64, E, u64)
        log(f"{tag} the check solve alone raised to cg_iters 80: relative "
            f"residual {relres:.3e}")
    check(relres < 1e-5, f"float64 CG relative residual {relres:.3e} >= "
          f"1e-5")
    floor = _relres(torch, p64, E, u64.float())
    c32 = float(prob.f @ u32)
    c64 = float(p64.f @ u64)
    log(f"{tag} float32 state solve: relative residual "
        f"{_relres(torch, p64, E, u32):.3e}; float32 floor (float64 "
        f"solution rounded) {floor:.3e}; float32 compliance {c32:.6e} vs "
        f"float64 {c64:.6e} (rel err {abs(c32 - c64) / abs(c64):.3e})")


def phase_mma3d_bench(torch):
    """Phase 19: bench.py's 3-D MMA configuration as a correctness check."""
    from paropt_torch.models.fem_topology3d import FEMTopology3D
    prob = FEMTopology3D(32, 16, 16, cg_iters=25, solver="mgcg",
                         dtype=torch.float32, device="cuda")
    solver = _mma_solver(torch, prob, 40, "float32")
    t0 = time.perf_counter()
    res, state = solver.solve()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    log(f"[mma3d 32x16x16 float32] outer iterations {res['niter']}, inner "
        f"{int(state.subiters)}, fobj {res['fobj']:.6f}, infeas "
        f"{res['infeas']:.3e}, l1 {res['l1']:.4e}; {wall:.2f} s = "
        f"{wall / max(res['niter'], 1):.4f} s per outer iteration, "
        f"{res['niter'] / wall:.3f} outer iterations/s")
    check(0.08 < res["fobj"] < 0.14,
          f"fobj {res['fobj']:.4f} outside bench.py's band (0.08, 0.14)")
    check(res["infeas"] < 1e-8, f"infeas {res['infeas']:.3e} >= 1e-8")


def phase_3d_crosscheck(torch):
    """Phase 20: the 3-D models in float64, card against host: FusedMMA,
    the host MMA through the facade and FusedTR on FEMTopology3D(8, 4, 4,
    mgcg), FusedMMA on DMOFEMTopology3D(6, 3, 3)."""
    from paropt_torch.models.fem_topology3d import (DMOFEMTopology3D,
                                                    FEMTopology3D)
    from paropt_torch.ops import kernels
    from paropt_torch.utils.logging import unpack_mma_output

    def fem(dev):
        return FEMTopology3D(8, 4, 4, cg_iters=25, solver="mgcg",
                             dtype=torch.float64, device=dev)

    def fused_mma(make, iters):
        def run(dev):
            res, st = _mma_solver(torch, make(dev), iters, "float64").solve()
            return res["fobj"], (res["niter"], int(st.subiters))
        return run

    def host_mma(dev):
        opt, res, _, _, _, path = _host_route(
            torch, fem(dev), {"algorithm": "mma", "mma_max_iterations": 6,
                              "dtype": "float64"},
            f"chip_smoke_cross_mma3d_{dev}.log")
        rows = unpack_mma_output(str(path))
        return res["fobj"], [rows[c].astype(int).tolist()
                             for c in ("iter", "subiter")]

    def fused_tr(dev):
        res, _ = _tr_solver(fem(dev), "float64",
                            tr_max_iterations=3).solve()
        return res["fobj"], (res["niter"], res["subiters"])

    cases = (("FusedMMA fem3d 8x4x4", fused_mma(fem, 6)),
             ("host MMA fem3d 8x4x4", host_mma),
             ("FusedTR fem3d 8x4x4", fused_tr),
             ("FusedMMA dmo3d 6x3x3", fused_mma(
                 lambda dev: DMOFEMTopology3D(6, 3, 3, cg_iters=250,
                                              dtype=torch.float64,
                                              device=dev), 6)))
    for name, run in cases:
        out = {}
        for dev in ("cuda", "cpu"):
            t0 = time.perf_counter()
            kernels.reset_launches()
            out[dev] = run(dev)
            log(f"[3d crosscheck] {name} {dev}: fobj {out[dev][0]:.15e}, "
                f"counts {out[dev][1]}, launches {dict(kernels.LAUNCHES)} "
                f"({time.perf_counter() - t0:.2f} s)")
        (fc, ic), (fh, ih) = out["cuda"], out["cpu"]
        check(ic == ih, f"{name}: iteration counts or log columns differ: "
              f"cuda {ic}, cpu {ih}")
        check(abs(fc - fh) <= 1e-9 * abs(fh),
              f"{name}: objectives differ: cuda {fc!r}, cpu {fh!r}")


KB = 4


def _starts(torch, x0, k, lo, hi, clip=None, seed=0):
    """k starts: x0 scaled by default_rng(seed).uniform(lo, hi), clipped to
    ``clip`` when given (numpy makes the scales, as the tests do)."""
    import numpy as np
    scale = np.random.default_rng(seed).uniform(lo, hi, (k, x0.shape[0]))
    xs = x0.detach().cpu().double().numpy()[None, :] * scale
    if clip is not None:
        xs = np.clip(xs, *clip)
    return torch.as_tensor(xs, dtype=x0.dtype, device=x0.device)


def phase_kernels_batched(torch, timing):
    """Phase 3b: each kernel's instance-axis launch at kb = 4 over the main
    path's shapes in float32 against the plain version batched (max abs
    error) and against 4 single launches (bit for bit), at kb = 1 against
    the single launch (bit for bit); times of the instance-axis launch, of
    4 single launches and of the plain version batched, and the bound (4
    times the single call's bytes).  Adds the results to ``timing``."""
    from paropt_torch.ops import kernels
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    W = N_MAIN // BLOCK
    B = 2 * MSUB + 1
    f32 = torch.float32

    def held(name, got, want, singles, one, one_want):
        err = max(rel_err(torch, g, w)[0] for g, w in zip(got, want))
        rel = max(rel_err(torch, g, w)[1] for g, w in zip(got, want))
        check(rel <= RTOL["float32"], f"{name} kb={KB}: relative error "
              f"{rel:.3e} > {RTOL['float32']:.0e}")
        for i, single in enumerate(singles):
            check(all(torch.equal(g[i], s) for g, s in zip(got, single)),
                  f"{name} kb={KB}: instance {i} differs from its single "
                  f"launch")
        check(all(torch.equal(g[0], s) for g, s in zip(one, one_want)),
              f"{name} kb=1: differs from the single launch")
        log(f"[kernels kb={KB}] {name}: max abs err {err:.3e} against the "
            f"plain version batched; {KB} instances and kb=1 bitwise equal "
            f"to single launches")
        return err

    def timed(name, batched, singles, plain, nbytes, flops):
        ms = cuda_ms(torch, batched)
        sms = cuda_ms(torch, singles)
        pms = cuda_ms(torch, plain)
        bms, by = bound_ms(nbytes, flops)
        log(f"[kernels kb={KB}] {name}: {ms:.4f} ms instance-axis launch, "
            f"{sms:.4f} ms {KB} single launches, {pms:.4f} ms plain "
            f"batched; bound {bms:.4f} ms by {by} ({nbytes / 1e6:.2f} MB), "
            f"{100 * bms / ms:.1f}% of bound; clocks.sm, power.draw, "
            f"power.limit: {smi_sample()}")
        return {"batched_ms": ms, "singles_ms": sms, "batched_plain_ms": pms,
                "batched_bound_ms": bms}

    buf = torch.randn((KB, 2 * MSUB, N_MAIN), device="cuda", dtype=f32,
                      generator=gen)
    s = torch.randn((KB, N_MAIN), device="cuda", dtype=f32, generator=gen)
    y = torch.randn((KB, N_MAIN), device="cuda", dtype=f32, generator=gen)
    upd = torch.tensor([True, False, True, True], device="cuda")
    got = kernels.qn_roll_update_batched(buf, s, y, upd)
    err = held("qn_roll_update", got,
               kernels.qn_roll_update_plain_batched(buf, s, y, upd),
               [kernels.qn_roll_update(buf[i], s[i], y[i], upd[i])
                for i in range(KB)],
               kernels.qn_roll_update_batched(buf[:1], s[:1], y[:1],
                                              upd[:1]),
               kernels.qn_roll_update(buf[0], s[0], y[0], upd[0]))
    r = timing["qn_roll_update"]
    r["batched_max_abs_err"] = err
    r.update(timed(
        "qn_roll_update", lambda: kernels.qn_roll_update_batched(
            buf, s, y, upd),
        lambda: [kernels.qn_roll_update(buf[i], s[i], y[i], upd[i])
                 for i in range(KB)],
        lambda: kernels.qn_roll_update_plain_batched(buf, s, y, upd),
        _nbytes(buf, s, y, upd, *got), KB * 4 * 2 * MSUB * N_MAIN))
    del buf, s, y, got

    # the quasi-definite apply at K = 1 with vals shared (stride 0), as a
    # batched solve passes it
    per = [_qd_inputs(torch, gen, 1, BLOCK, W, f32) for _ in range(KB)]
    ops = [torch.stack([p[j] for p in per]) for j in range(5)]
    ops[2] = ops[2][0].expand(KB, BLOCK, W)
    got = kernels.quasi_def_apply_batched(*ops)
    err = held("quasi_def_apply K=1", got,
               kernels.quasi_def_apply_plain_batched(*ops),
               [kernels.quasi_def_apply(*(o[i] for o in ops))
                for i in range(KB)],
               kernels.quasi_def_apply_batched(*(o[:1] for o in ops)),
               kernels.quasi_def_apply(*(o[0] for o in ops)))
    r = timing["quasi_def_apply"]
    r["batched_max_abs_err"] = err
    r.update(timed(
        "quasi_def_apply K=1",
        lambda: kernels.quasi_def_apply_batched(*ops),
        lambda: [kernels.quasi_def_apply(*(o[i] for o in ops))
                 for i in range(KB)],
        lambda: kernels.quasi_def_apply_plain_batched(*ops),
        _nbytes(ops[0], ops[1], ops[2][0], ops[3], ops[4], *got),
        KB * W * (6 * BLOCK + 2)))

    # phi_gram as the factor setup calls it: [Z_qn; A] as two row blocks,
    # bw = 0, vals shared
    per = [_qd_inputs(torch, gen, B, BLOCK, W, f32) for _ in range(KB)]
    dinv, cwinv, vals, bx = (torch.stack([p[j] for p in per])
                             for j in range(4))
    vals = vals[0].expand(KB, BLOCK, W)
    args = (dinv, cwinv, vals, bx[:, :2 * MSUB], None, bx[:, 2 * MSUB:])

    def pick(i):
        return [None if a is None else a[i] for a in args]

    got = kernels.phi_gram_batched(*args)
    err = held("phi_gram B=21", got, kernels.phi_gram_plain_batched(*args),
               [kernels.phi_gram(*pick(i)) for i in range(KB)],
               kernels.phi_gram_batched(*(None if a is None else a[:1]
                                          for a in args)),
               kernels.phi_gram(*pick(0)))
    r = timing["phi_gram"]
    r["batched_max_abs_err"] = err
    r.update(timed(
        "phi_gram B=21", lambda: kernels.phi_gram_batched(*args),
        lambda: [kernels.phi_gram(*pick(i)) for i in range(KB)],
        lambda: kernels.phi_gram_plain_batched(*args),
        _nbytes(dinv, cwinv, vals[0], bx, *got),
        KB * (2 * B * B * BLOCK * W + B * W * (6 * BLOCK + 2))))


def _perturbed(torch, x, seed=5):
    """x with every entry moved by a relative 1e-7 (uniform in [0, 1e-7)):
    a start that differs from x by roundoff, to measure how far a float32
    solve moves under roundoff alone."""
    g = torch.Generator(device=x.device).manual_seed(seed)
    return x * (1 + 1e-7 * torch.rand(x.shape, generator=g, device=x.device,
                                      dtype=x.dtype))


def _rel(a, b):
    return abs(a - b) / abs(b)


def phase_batched_ip(torch):
    """Batched IP at full width: k = 4 starts of the main path's problem.
    float32 (the main path): every instance converges below 1e-6, every
    launch has the instance axis and one batched step launches each kernel
    as often as one single step; each instance is printed beside its own
    single solve and beside a single solve from its start moved by 1e-7
    (float32's roundoff floor on this solve).  float64 at the same width:
    each instance within one iteration of its own single solve and fobj
    within 1e-5.  Returns the float32 batch's launches."""
    from paropt_torch import ip_fused as tip
    from paropt_torch.ops import kernels
    from paropt_torch.tree import take
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).split(".")[1]
        tag = f"[batched ip k={KB} n={N_MAIN} {name}]"
        fused, data, x0, qn0 = _build_solver(torch, N_MAIN, dtype, "cuda")
        x0s = _starts(torch, x0, KB, 0.5, 1.5)
        fused.solve_batched(x0s, data, (), qn0, max_iters=2)    # warm-up
        singles = []
        for i in range(KB):
            fused.syncs.count = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st = fused.solve(x0s[i], data, (), qn0)
            torch.cuda.synchronize()
            singles.append((int(st.k), float(st.fobj),
                            time.perf_counter() - t0, fused.syncs.count,
                            bool(st.converged)))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fused.syncs.count = 0
        kernels.reset_launches()
        t0 = time.perf_counter()
        st = fused.solve_batched(x0s, data, (), qn0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        batched = dict(kernels.BATCHED_LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2**30
        steps = int(st.k.max()) + 1          # the converging turn freezes
        reads = fused.syncs.count
        s_steps = sum(k + 1 for k, *_ in singles)
        s_reads = sum(r for *_, r, _ in singles)
        s_wall = sum(t for _, _, t, _, _ in singles)
        fobj = st.fobj.tolist()
        log(f"{tag} iterations {st.k.tolist()} (single solves "
            f"{[k for k, *_ in singles]}), converged "
            f"{st.converged.tolist()}, res_norm "
            f"{[f'{r:.3e}' for r in st.res_norm.tolist()]}")
        log(f"{tag} fobj {[f'{f:.12e}' for f in fobj]} (single "
            f"{[f'{f:.12e}' for _, f, *_ in singles]})")
        log(f"{tag} wall {wall:.4f} s = {wall / steps * 1e3:.2f} ms per "
            f"batched step ({steps} steps); {KB} single solves "
            f"{s_wall:.4f} s = {s_wall / s_steps * 1e3:.2f} ms per step; "
            f"host reads {reads / steps:.2f} per batched step, "
            f"{s_reads / s_steps:.2f} per single step; peak memory "
            f"{peak:.3f} GiB")
        log(f"{tag} kernel launches {launches}, of them instance-axis "
            f"{batched}")
        check(bool(torch.all(st.converged)), "a batched instance did not "
              "converge")
        check(float(torch.max(st.res_norm)) < 1e-6,
              f"res_norm {float(torch.max(st.res_norm)):.3e} >= 1e-6")
        check(torch.isfinite(st.vars.x).all().item()
              and st.vars.x.shape == (KB, N_MAIN), "bad final x")
        for nm, count in launches.items():
            check(count > 0 and batched[nm] == count,
                  f"kernel {nm}: {count} launches, {batched[nm]} with the "
                  f"instance axis")
        if dtype == torch.float64:
            for i, (k, f, _, _, conv) in enumerate(singles):
                check(conv, f"single solve {i} did not converge")
                check(abs(int(st.k[i]) - k) <= 1, f"instance {i}: "
                      f"{int(st.k[i])} iterations against {k} single")
                check(_rel(fobj[i], f) <= 1e-5, f"instance {i}: fobj "
                      f"{fobj[i]!r} against {f!r}")
            continue
        # float32: the roundoff floor, and one profiled batched step
        moved = [fused.solve(_perturbed(torch, x0s[i]), data, (), qn0)
                 for i in range(KB)]
        log(f"{tag} against the single solves: iterations "
            f"{[int(st.k[i]) - k for i, (k, *_) in enumerate(singles)]}, "
            f"fobj rel {[f'{_rel(fobj[i], f):.1e}' for i, (_, f, *_) in enumerate(singles)]}; "
            f"single solves from starts moved by 1e-7: iterations "
            f"{[int(m.k) - k for m, (k, *_) in zip(moved, singles)]}, fobj "
            f"rel {[f'{_rel(float(m.fobj), f):.1e}' for m, (_, f, *_) in zip(moved, singles)]}")
        out = batched
        mid = fused.solve_batched(x0s, data, (), qn0, max_iters=10)
        run = tip._Run(fused.syncs, batched=True)

        def step():
            return tip._fused_step(fused.model, fused.opts, mid, data, (),
                                   None, run=run)

        window, nops, busy, _ = _profile_call(torch, step)
        _log_busy(tag, "one batched step (from step 10)", window, nops, busy)
        kernels.reset_launches()
        step()
        per_batched = dict(kernels.LAUNCHES)
        kernels.reset_launches()
        fused.step(take(mid, 0), data, (), None)
        per_single = dict(kernels.LAUNCHES)
        log(f"{tag} launches in one step: batched {per_batched}, single "
            f"{per_single}")
        check(per_batched == per_single, "a batched step launches the "
              "kernels a different number of times than a single step")
    return out


def phase_batched_small(torch):
    """scripts/bench_batched.py's defaults (n = 4096, k = 32, tol 1e-4,
    float32 on the card): the batched solve against 32 sequential single
    solves, wall time both ways.  The ratio is recorded, not claimed."""
    n, k, tol = 4096, 32, 1e-4
    tag = f"[batched ip k={k} n={n} float32]"
    fused, data, x0, qn0 = _build_solver(torch, n, torch.float32, "cuda",
                                         abs_res_tol=tol,
                                         iterative_refinement_steps=1)
    x0s = _starts(torch, x0, k, 0.5, 1.5)
    fused.solve_batched(x0s, data, (), qn0, max_iters=2)    # warm-up
    fused.solve(x0s[0], data, (), qn0, max_iters=2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = fused.solve_batched(x0s, data, (), qn0)
    torch.cuda.synchronize()
    tb = time.perf_counter() - t0
    t0 = time.perf_counter()
    seq = [fused.solve(x0s[i], data, (), qn0) for i in range(k)]
    torch.cuda.synchronize()
    ts = time.perf_counter() - t0
    conv_s = [bool(s.converged) for s in seq]
    iters_s = [int(s.k) for s in seq]
    log(f"{tag} batched {tb:.3f} s (converged "
        f"{int(st.converged.sum())}/{k}, iterations max "
        f"{int(st.k.max())}) vs {k} sequential {ts:.3f} s (converged "
        f"{sum(conv_s)}/{k}, iterations max {max(iters_s)}, total "
        f"{sum(iters_s)}): sequential / batched = {ts / tb:.2f}")
    check(torch.isfinite(st.fobj).all().item(), "non-finite batched fobj")
    check(st.converged.tolist() == conv_s,
          "batched and sequential solves disagree on convergence")
    for i, s in enumerate(seq):
        check(abs(float(st.fobj[i]) - float(s.fobj))
              <= 1e-5 * abs(float(s.fobj)),
              f"instance {i}: fobj {float(st.fobj[i])!r} against "
              f"{float(s.fobj)!r}")


def _mma_single(solver, x):
    import dataclasses
    return solver.solve(dataclasses.replace(solver._state0, x=x, x1=x, x2=x))


def _tr_single(solver, x):
    import dataclasses
    f0, c0, cw0 = solver._ev((), x)
    g0, A0 = solver._gr((), x)
    return solver.solve(dataclasses.replace(
        solver._state0, xk=x, fk=f0, ck=c0, gk=g0, Ak=A0, cwk=cw0))


def _batch_and_one(torch, tag, make_solver, single, x0s, i):
    """A batched solve of the starts x0s and the single solve of start i:
    (batched results, states, single result, single state, the batch's
    launches and instance-axis launches), with times and reads printed."""
    from paropt_torch.ops import kernels
    solver = make_solver()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    res, states = solver.solve_batched(x0s)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = dict(kernels.LAUNCHES)
    batched = dict(kernels.BATCHED_LAUNCHES)
    one = make_solver()
    t0 = time.perf_counter()
    r1, s1 = single(one, x0s[i])
    torch.cuda.synchronize()
    ws = time.perf_counter() - t0
    niter = int(res["niter"].max())
    log(f"{tag} outer iterations {res['niter'].tolist()}, inner "
        f"{states.subiters.tolist()}, converged "
        f"{res['converged'].tolist()}, fobj {res['fobj'].tolist()}, infeas "
        f"{res['infeas'].tolist()}, linf {res['linfty'].tolist()}")
    log(f"{tag} wall {wall:.3f} s = {wall / niter:.4f} s per batched outer "
        f"iteration ({solver.syncs.count / niter:.1f} host reads each); "
        f"instance {i} alone {ws / max(r1['niter'], 1):.4f} s per outer "
        f"iteration ({one.syncs.count / max(r1['niter'], 1):.1f} reads), "
        f"niter {r1['niter']}, inner {int(s1.subiters)}, fobj "
        f"{r1['fobj']:.12e}; peak memory {peak:.3f} GiB; launches "
        f"{launches}, of them instance-axis {batched}")
    import numpy as np
    check(np.isfinite(res["fobj"]).all(), "non-finite fobj")
    check(launches == batched, "a launch without the instance axis")
    return res, states, r1, launches


def _held(tag, res, r1, i, rtol):
    check(int(res["niter"][i]) == r1["niter"], f"{tag} instance {i}: "
          f"{res['niter'][i]} outer iterations against {r1['niter']}")
    check(_rel(float(res["fobj"][i]), r1["fobj"]) <= rtol,
          f"{tag} instance {i}: fobj {float(res['fobj'][i])!r} against "
          f"{r1['fobj']!r}")
    log(f"{tag} instance {i} equals its single solve: niter "
        f"{r1['niter']}, fobj rel {_rel(float(res['fobj'][i]), r1['fobj']):.1e}")


def _f32_floor(tag, res, r1, moved, i):
    log(f"{tag} instance {i} against its single solve: niter "
        f"{int(res['niter'][i]) - r1['niter']:+d}, fobj rel "
        f"{_rel(float(res['fobj'][i]), r1['fobj']):.1e}; the single solve "
        f"from its start moved by 1e-7: niter {moved['niter'] - r1['niter']:+d}"
        f", fobj rel {_rel(moved['fobj'], r1['fobj']):.1e}")


def phase_batched_mma(torch):
    """Batched FusedMMA at full width: k = 4 starts on FEMTopology(768,
    384, mgcg), clipped to [0.05, 0.95] from uniform(0.6, 1.4).  float32,
    10 outer iterations (a depth cut): infeasibility < 1e-6 for every
    instance, no kernel launched, instance 1 printed beside its single
    solve and float32's roundoff floor.  float64, 3 outer iterations:
    instance 1 equals its single solve (niter, fobj within 1e-5)."""
    from paropt_torch.models.fem_topology import FEMTopology
    for dtype, iters in ((torch.float32, 10), (torch.float64, 3)):
        name = str(dtype).split(".")[1]
        tag = f"[batched mma k={KB} 768x384 {name}]"
        prob = FEMTopology(768, 384, cg_iters=25, solver="mgcg",
                           dtype=dtype, device="cuda")
        x0, _, _ = prob.get_vars_and_bounds()
        x0s = _starts(torch, x0, KB, 0.6, 1.4, clip=(0.05, 0.95))

        def make():
            return _mma_solver(torch, prob, iters, name)

        res, _, r1, launches = _batch_and_one(torch, tag, make, _mma_single,
                                              x0s, 1)
        check((res["infeas"] < 1e-6).all(), f"infeas {res['infeas']} >= "
              f"1e-6")
        check(not any(launches.values()),
              f"a phase-3 kernel ran on the MMA/FEM path: {launches}")
        if dtype == torch.float64:
            _held(tag, res, r1, 1, 1e-5)
        else:
            moved, _ = _mma_single(make(), _perturbed(torch, x0s[1]))
            _f32_floor(tag, res, r1, moved, 1)


def phase_batched_tr(torch):
    """Batched FusedTR with k = 4: phase 9's configuration (n = 2^20,
    float32: every instance converged, all three kernels launched, each
    with the instance axis, instance 2 equal to its single solve in niter
    and fobj within 1e-5), and bench.py's FEM 48x24 as
    examples/fem_topology_tr.py runs it (float32, 6 outer iterations:
    only qn_roll_update, instance 2 printed beside its single solve and
    float32's roundoff floor; float64, 4 outer iterations: instance 2
    equal to its single solve, fobj within 1e-5).  Returns the n = 2^20
    batch's launches."""
    from paropt_torch.models.fem_topology import FEMTopology
    from paropt_torch.models.topology import SyntheticTopology
    tag = f"[batched tr k={KB} n={N_MAIN} float32]"
    prob = SyntheticTopology(n=N_MAIN, block=BLOCK, dtype=torch.float32,
                             device="cuda")
    x0, _, _ = prob.get_vars_and_bounds()
    res, _, r2, out = _batch_and_one(
        torch, tag, lambda: _tr_solver(prob, "float32"), _tr_single,
        _starts(torch, x0, KB, 0.5, 1.5), 2)
    check(res["converged"].all() and (res["infeas"] < 1e-5).all()
          and (res["linfty"] < 1e-5).all(),
          "a batched TR instance did not converge")
    for k, count in out.items():
        check(count > 0, f"kernel {k} was not launched")
    _held(tag, res, r2, 2, 1e-5)
    for dtype, iters in ((torch.float32, 6), (torch.float64, 4)):
        name = str(dtype).split(".")[1]
        tag = f"[batched tr k={KB} fem 48x24 {name}]"
        prob = FEMTopology(48, 24, cg_iters=25, solver="mgcg", dtype=dtype,
                           device="cuda")
        x0, _, _ = prob.get_vars_and_bounds()
        x0s = _starts(torch, x0, KB, 0.6, 1.4, clip=(0.05, 0.95))

        def make():
            return _tr_solver(prob, name, tr_max_iterations=iters)

        res, _, r2, launches = _batch_and_one(torch, tag, make, _tr_single,
                                              x0s, 2)
        check(launches["qn_roll_update"] > 0
              and launches["quasi_def_apply"] == launches["phi_gram"] == 0,
              f"unexpected launches on the FEM TR path: {launches}")
        if dtype == torch.float64:
            _held(tag, res, r2, 2, 1e-5)
        else:
            moved, _ = _tr_single(make(), _perturbed(torch, x0s[2]))
            _f32_floor(tag, res, r2, moved, 2)
    return out


def phase_batched_crosscheck(torch):
    """The three batched solves at the CPU tests' sizes in float64 (depths
    cut: the IP to 60 steps, the MMA and TR to 6 and 4 outer iterations),
    on the card and on the host: equal counts, fobj within 1e-12
    relative, per instance."""
    from paropt_torch import ip_fused as tip
    from paropt_torch.models.fem_topology import FEMTopology
    from paropt_torch.models.topology import SyntheticTopology
    from paropt_torch.mma import FusedMMA
    from paropt_torch.ops import qn as qnmod
    from paropt_torch.tr import FusedTR
    f64 = torch.float64

    def ip(dev):
        prob = SyntheticTopology(n=256, block=8, dtype=f64, device=dev)
        fused = tip.FusedIP(tip.model_from_problem(prob), 256, 1, prob.nwcon,
                            1, tip.FusedIPOptions(
                                use_quasi_newton_update=True,
                                abs_res_tol=1e-5, max_major_iters=60),
                            dtype=f64)
        data, x0 = tip.data_template_from_problem(prob, dtype=f64)
        st = fused.solve_batched(_starts(torch, x0, 3, 0.4, 1.6), data, (),
                                 qnmod.qn_init(5, 256, dtype=f64,
                                               device=dev))
        return st.k.tolist(), st.fobj.tolist()

    def fem(dev):
        return FEMTopology(8, 4, cg_iters=200, dtype=f64, device=dev)

    def mma(dev):
        prob = fem(dev)
        x0, _, _ = prob.get_vars_and_bounds()
        res, st = FusedMMA(prob, {"mma_max_iterations": 6,
                                  "mma_output_file": None}).solve_batched(
            _starts(torch, x0, 3, 0.6, 1.4, clip=(0.05, 0.95)))
        return ([*res["niter"].tolist(), *st.subiters.tolist()],
                res["fobj"].tolist())

    def tr(dev):
        prob = fem(dev)
        x0, _, _ = prob.get_vars_and_bounds()
        res, st = FusedTR(prob, {
            "tr_output_file": None, "output_file": None,
            "tr_max_iterations": 4, "abs_res_tol": 1e-7,
            "tr_infeas_tol": 1e-5, "tr_l1_tol": 0.0,
            "tr_linfty_tol": 1e-5}).solve_batched(
            _starts(torch, x0, 3, 0.6, 1.4, clip=(0.05, 0.95), seed=1))
        return ([*res["niter"].tolist(), *st.subiters.tolist()],
                res["fobj"].tolist())

    for name, fn in (("ip synthetic 256", ip), ("mma fem 8x4", mma),
                     ("tr fem 8x4", tr)):
        out = {}
        for dev in ("cuda", "cpu"):
            t0 = time.perf_counter()
            out[dev] = fn(dev)
            log(f"[batched crosscheck] {name} {dev}: counts {out[dev][0]}, "
                f"fobj {[f'{f:.15e}' for f in out[dev][1]]} "
                f"({time.perf_counter() - t0:.2f} s)")
        (kc, fc), (kh, fh) = out["cuda"], out["cpu"]
        check(kc == kh, f"{name}: counts differ: cuda {kc}, cpu {kh}")
        for a, b in zip(fc, fh):
            check(abs(a - b) <= 1e-12 * abs(b),
                  f"{name}: objectives differ: cuda {a!r}, cpu {b!r}")


def main():
    import torch
    check((ROOT / "paropt_torch" / "csrc").is_dir(),
          f"paropt_torch not found beside {Path(__file__).name}")
    sys.path.insert(0, str(ROOT))
    phase_device(torch)
    phase_build()
    timing = phase_kernels(torch)
    phase_kernels_batched(torch, timing)
    launches, ip_iters = phase_slice(torch)
    phase_crosscheck(torch)
    for dtype in (torch.float32, torch.float64):
        phase_mma_full(torch, dtype, iters=10)
    phase_mma_bench(torch)
    phase_mma_crosscheck(torch)
    tr_launches, tr_niter, tr_fobj = phase_tr_full(torch)
    phase_tr_bench(torch)
    phase_tr_crosscheck(torch)
    host_tr_launches = phase_host_tr_full(torch, tr_niter, tr_fobj)
    host_ip_launches, host_ip_iters = phase_host_ip_full(torch, ip_iters)
    phase_host_mma(torch)
    phase_host_crosscheck(torch)
    nk_launches = phase_nk_full(torch, ip_iters, host_ip_iters)
    phase_nk_crosscheck(torch)
    phase_mma3d_full(torch)
    phase_mma3d_bench(torch)
    phase_3d_crosscheck(torch)
    batched_launches = phase_batched_ip(torch)
    phase_batched_small(torch)
    phase_batched_mma(torch)
    batched_tr_launches = phase_batched_tr(torch)
    phase_batched_crosscheck(torch)
    rows = []
    for name, (source, replaces) in KERNELS.items():
        r = timing[name]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[name],
                     "tr_launches": tr_launches[name],
                     "host_tr_launches": host_tr_launches[name],
                     "host_ip_launches": host_ip_launches[name],
                     "nk_launches": nk_launches[name],
                     "batched_launches": batched_launches[name],
                     "batched_tr_launches": batched_tr_launches[name],
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"], "library_ms": None,
                     **{key: r[key] for key in (
                         "batched_max_abs_err", "batched_ms", "singles_ms",
                         "batched_plain_ms", "batched_bound_ms")}})
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
