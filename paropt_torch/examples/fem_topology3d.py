"""3-D SIMP cantilever topology optimization on the voxel FEM model
(examples/fem_topology3d.py on the port): the whole MMA outer loop (FEM
solves, asymptotes, separable subproblems, inner IP) in FusedMMA, in
windows of ``--chunk`` outer iterations.  float32 on the card, float64 on
the CPU, as the JAX script.

    python -m paropt_torch.examples.fem_topology3d --nex 32 --ney 16 --nez 16
"""

import argparse
import time

from ..models.fem_topology3d import FEMTopology3D
from ..mma import FusedMMA
from ._common import accelerator_dtype, add_device, chunk_arg, host


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nex", type=int, default=16)
    ap.add_argument("--ney", type=int, default=8)
    ap.add_argument("--nez", type=int, default=8)
    ap.add_argument("--iters", type=int, default=40)
    ap.add_argument("--cg-iters", type=int, default=None)
    ap.add_argument("--solver", default="mgcg", choices=["jacobi", "mgcg"])
    ap.add_argument("--volume", type=float, default=0.3)
    ap.add_argument("--repeat", action="store_true",
                    help="run the solve again to report steady throughput "
                         "(first-call costs excluded)")
    ap.add_argument("--chunk", default="auto",
                    help="outer iterations per window: int, 'auto', or "
                         "'none'")
    add_device(ap)
    args = ap.parse_args(argv)
    chunk = chunk_arg(args.chunk)
    dtype = accelerator_dtype(args.device)

    cg = args.cg_iters or (40 if args.solver == "mgcg" else 400)
    prob = FEMTopology3D(nex=args.nex, ney=args.ney, nez=args.nez,
                         volume_fraction=args.volume, cg_iters=cg,
                         solver=args.solver, dtype=dtype, device=args.device)
    print(f"elements: {prob.ne}  dofs: {prob.ndof}")
    solver = FusedMMA(prob, {"mma_max_iterations": args.iters,
                             "mma_output_file": None,
                             "dtype": str(dtype).split(".")[-1]})
    t0 = time.time()
    res, state = solver.solve(chunk=chunk)
    wall = time.time() - t0
    x = host(res["x"])
    print(f"{args.iters} MMA iterations in {wall:.1f}s "
          f"(incl. first-call costs): compliance {res['fobj']:.4f} "
          f"(vs 1.0 at uniform start), volume {x.mean():.3f} "
          f"(bound {args.volume}), infeas {res['infeas']:.1e}")
    out = {"fobj": float(res["fobj"]), "volume": float(x.mean()),
           "infeas": float(res["infeas"]), "niter": res["niter"]}
    if args.repeat:
        t0 = time.time()
        res, state = solver.solve(chunk=chunk)
        wall = time.time() - t0
        print(f"again: {res['niter']} iterations in {wall:.1f}s "
              f"({res['niter'] / wall:.2f} outer-it/s)")
    return out


if __name__ == "__main__":
    main()
