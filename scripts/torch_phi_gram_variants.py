#!/usr/bin/env python3
"""Time layout variants of the quasi-definite kernels on one CUDA card.

    python3 scripts/torch_phi_gram_variants.py [variant ...]

Each variant is a copy of ``paropt_torch`` (under ``build/variants/<name>``)
with a few lines of ``csrc/`` or of the wrapper's planner replaced; the
copy builds its own library and, in a process of its own, times
``phi_gram`` at the main path's shape (B = 21 as the factor setup calls it,
k = 8, nwcon = 2^17) and ``quasi_def_apply`` at K = 1 and 21, in float32
and float64, with chip_smoke.py's timer (CUDA events, median of 20 runs,
L2 flushed), after checking each against its plain version.  One line of
JSON per variant; "base" is the checkout as it is.  The "diag_" variants
drop a phase of phi_gram to show where its time goes; their results are
wrong by design and are not checked.  Compare variants only within one
run.
"""

import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CU = "paropt_torch/csrc/quasi_def.cu"
CUH = "paropt_torch/csrc/common.cuh"
PY = "paropt_torch/ops/kernels.py"
PLAN = ("for per_sm, tiles in ((2, (32, 16, 8)), "
        "(1, (64, 32, 16, 8, 4))):")
BOUNDS = "__launch_bounds__(kPgThreads, MT == 1 ? 2 : 1)"
CP16 = 'asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;'


def blocks(n):
    """n resident blocks of 256 threads per SM, 16-column tiles."""
    return [(CU, BOUNDS, f"__launch_bounds__(kPgThreads, MT == 1 ? {n} : 1)"),
            (PY, PLAN, f"for per_sm, tiles in (({n}, (16,)), "
                       "(1, (64, 32, 16, 8, 4))):")]


def layout(per_sm, tile):
    """per_sm resident blocks, tile columns (the ring keeps two stages:
    the Gram reduction's place in shared memory needs that)."""
    return [(CU, BOUNDS,
             f"__launch_bounds__(kPgThreads, MT == 1 ? {per_sm} : 1)"),
            (PY, PLAN, f"for per_sm, tiles in (({per_sm}, ({tile}, "
                       f"{tile // 2}, {tile // 4})), (1, (16, 8, 4))):")]


# the 16-byte copies as a load to registers and a shared store, not cp.async
BY_LOAD = (CU, "      cp_async<16>(dst + h * (16 / sizeof(T)), s + h * (16 / sizeof(T)), ok);",
           "      *reinterpret_cast<float4*>(dst + h * (16 / sizeof(T))) = ok ? "
           "*reinterpret_cast<const float4*>(s + h * (16 / sizeof(T))) : "
           "make_float4(0.f, 0.f, 0.f, 0.f);")
NO_GRAM = (CU, "      if (g < G) {\n        for (int c = g;",
           "      if (false) {\n        for (int c = g;")
NO_APPLY = (CU, "for (int item = tid; item < B * qt; item += kPgThreads) {",
            "for (int item = tid; item < 0; item += kPgThreads) {")
# yx and yw stored without the evict-first hint (plain st.global)
PLAIN_STORES = [
    (CU, "        __stcs(reinterpret_cast<float4*>(dst + w) + h,\n"
         "               reinterpret_cast<const float4*>(&v)[h]);",
     "        reinterpret_cast<float4*>(dst + w)[h] =\n"
     "            reinterpret_cast<const float4*>(&v)[h];"),
    (CU, "if (w + e < W) __stcs(dst + w + e, v.v[e]);",
     "if (w + e < W) dst[w + e] = v.v[e];")]


# name -> [(file, text, replacement)]
VARIANTS = {
    "base": [],
    "gram_loop_unrolled_2": [
        (CU, "      for (int c = g; c < nch; c += G) {",
         "#pragma unroll 2\n      for (int c = g; c < nch; c += G) {")],
    "3_blocks_per_sm_tile_16": blocks(3),
    "4_blocks_per_sm_tile_16": blocks(4),
    "copies_prefetch_l2_128B": [
        (CUH, CP16, CP16.replace("global [", "global.L2::128B ["))],
    "copies_prefetch_l2_256B": [
        (CUH, CP16, CP16.replace("global [", "global.L2::256B ["))],
    "apply_blocks_of_64": [(CU, "constexpr int kQdThreads = 128;",
                            "constexpr int kQdThreads = 64;")],
    "apply_blocks_of_256": [(CU, "constexpr int kQdThreads = 128;",
                             "constexpr int kQdThreads = 256;")],
    "plain_stores": PLAIN_STORES,
    "diag_no_gram": [NO_GRAM],
    "diag_no_apply": [NO_APPLY],
    "diag_copies_only": [NO_GRAM, NO_APPLY],
    "copies_by_load": [BY_LOAD],
    # nwcon off a power of two: rows 512 KB + 128 B apart in f32
    "nwcon_plus_32": [("PROBE", "W = 21, 21, (1 << 20) // 8",
                       "W = 21, 21, (1 << 20) // 8 + 32")],
    "diag_copies_only_nwcon_plus_32": [
        NO_GRAM, NO_APPLY, ("PROBE", "W = 21, 21, (1 << 20) // 8",
                            "W = 21, 21, (1 << 20) // 8 + 32")],
    "diag_copies_only_by_load": [NO_GRAM, NO_APPLY, BY_LOAD],
    # the copies alone under another ring: bytes in flight per SM and the
    # length of each row's segment (tile × 4 bytes in f32)
    "diag_copies_only_tile_64_1_block": [NO_GRAM, NO_APPLY]
    + layout(1, 64),
}

PROBE = r'''
import json, sys, torch
CHECK = sys.argv[1] == "check"
sys.path.insert(0, ".")
import chip_smoke as c
from paropt_torch.ops import kernels
gen = torch.Generator(device="cuda")
gen.manual_seed(0)
B, K21, W = 21, 21, (1 << 20) // 8
out = {}
for dt in (torch.float32, torch.float64):
    name = str(dt).split(".")[1]
    dinv, cwinv, vals, bx, _ = c._qd_inputs(torch, gen, B, 8, W, dt)
    z, a = bx[:B - 1], bx[B - 1:]
    call = lambda: kernels.phi_gram(dinv, cwinv, vals, z, None, a)
    want = kernels.phi_gram_plain(dinv, cwinv, vals, z, None, a)
    rel = max(c.rel_err(torch, g, w)[1] for g, w in zip(call(), want))
    assert rel <= c.RTOL[name] or not CHECK, rel
    out[f"phi_gram {name}"] = c.cuda_ms(torch, call)
    for K in (1, K21):
        args = c._qd_inputs(torch, gen, K, 8, W, dt)
        call = lambda: kernels.quasi_def_apply(*args)
        rel = max(c.rel_err(torch, g, w)[1] for g, w in
                  zip(call(), kernels.quasi_def_apply_plain(*args)))
        assert rel <= c.RTOL[name] or not CHECK, rel
        out[f"quasi_def_apply K={K} {name}"] = c.cuda_ms(torch, call)
print(json.dumps(out))
'''


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    names = sys.argv[1:] or list(VARIANTS)
    for name in names:
        edits = VARIANTS[name]
        d = ROOT / "build" / "variants" / name
        if d.exists():
            shutil.rmtree(d)
        d.mkdir(parents=True)
        shutil.copy(ROOT / "chip_smoke.py", d / "chip_smoke.py")
        shutil.copytree(ROOT / "paropt_torch", d / "paropt_torch",
                        ignore=shutil.ignore_patterns("__pycache__"))
        probe = PROBE
        for rel, old, new in edits:
            if rel == "PROBE":
                probe = probe.replace(old, new)
                continue
            path = d / rel
            text = path.read_text()
            if old not in text:
                raise SystemExit(f"{name}: {rel} no longer holds {old!r}")
            path.write_text(text.replace(old, new))
        mode = "skip" if name.startswith("diag_") else "check"
        r = subprocess.run([sys.executable, "-c", probe, mode], cwd=d,
                           capture_output=True, text=True)
        if r.returncode != 0:
            print(json.dumps({"variant": name, "failed": r.stderr[-2000:]}),
                  flush=True)
            continue
        ms = json.loads(r.stdout.strip().splitlines()[-1])
        print(json.dumps({"variant": name,
                          "ms": {k: round(v, 4) for k, v in ms.items()}}),
              flush=True)


if __name__ == "__main__":
    main()
