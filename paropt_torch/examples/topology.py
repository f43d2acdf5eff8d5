"""Large-scale synthetic topology optimization with the fused interior
point (examples/topology.py on the port): one dense volume constraint,
per-block sparse weighting constraints, the solve through
`ip_fused.FusedIP` and its three CUDA kernels on the card.  float32 on
the card, float64 on the CPU, as the JAX script.

    python -m paropt_torch.examples.topology [--n 1048576] [--jit-loop] [--chunk 5]

``--jit-loop``: ``FusedIP.solve(jit_loop=True)``, the loop stopped at the
absolute iteration cap, in windows of ``--chunk`` (int, 'auto' or
'none'; one window without it); otherwise the per-step host loop.
"""

import argparse
import time

import torch

from .. import ip_fused
from ..models.topology import SyntheticTopology
from ..ops import qn as qnmod
from ._common import accelerator_dtype, add_device, chunk_arg


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--n", type=int, default=1 << 17)
    p.add_argument("--jit-loop", action="store_true",
                   help="the solve to the absolute cap (FusedIP.solve("
                        "jit_loop=True)), in windows of --chunk")
    p.add_argument("--chunk", default=None,
                   help="with --jit-loop: outer iterations per window: "
                        "int, 'auto', or 'none' (default: one window)")
    add_device(p)
    args = p.parse_args(argv)

    dtype = accelerator_dtype(args.device)
    prob = SyntheticTopology(n=args.n, block=8, dtype=dtype,
                             device=args.device)
    model = ip_fused.model_from_problem(prob)
    opts = ip_fused.FusedIPOptions(
        use_quasi_newton_update=True,
        abs_res_tol=1e-5 if dtype == torch.float32 else 1e-6,
        max_major_iters=300)
    fused = ip_fused.FusedIP(model, prob.nvars, prob.ncon, prob.nwcon,
                             prob.nwblock, opts, dtype=dtype)
    data, x0 = ip_fused.data_template_from_problem(prob, dtype=dtype)
    qn0 = qnmod.qn_init(10, prob.nvars, dtype=dtype, device=x0.device)

    t0 = time.time()
    chunk = None if args.chunk is None else chunk_arg(args.chunk)
    out = fused.solve(x0, data, (), qn0, None, jit_loop=args.jit_loop,
                      chunk=chunk)
    if out.k.device.type == "cuda":
        torch.cuda.synchronize(out.k.device)
    dt = time.time() - t0
    iters = int(out.k)
    print(f"n={args.n}  converged={bool(out.converged)}  "
          f"iters={iters}  f*={float(out.fobj):.6e}")
    print(f"res={float(out.res_norm):.3e}  mu={float(out.mu):.3e}  "
          f"wall={dt:.2f}s  ({iters / max(dt, 1e-9):.1f} it/s)")
    print(f"volume constraint: {float(out.c[0]):.6e} (>= 0)")
    return {"converged": bool(out.converged), "niter": iters,
            "fobj": float(out.fobj), "res_norm": float(out.res_norm),
            "mu": float(out.mu), "c": float(out.c[0])}


if __name__ == "__main__":
    main()
