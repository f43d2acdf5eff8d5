"""2-D SIMP topology optimization end to end (examples/fem_topology.py on
the port): optimize a cantilever and render the density field.

    python -m paropt_torch.examples.fem_topology [--nex 48] [--ney 24] [-o design.png]
"""

import argparse
import time

from ..models.fem_topology import FEMTopology
from ..mma import FusedMMA
from ..optimizer import Optimizer
from ._common import add_device, host, pyplot


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nex", type=int, default=48)
    ap.add_argument("--ney", type=int, default=24)
    ap.add_argument("--iters", type=int, default=60)
    ap.add_argument("--algorithm", default="mma", choices=["ip", "tr", "mma"])
    ap.add_argument("--fused", action="store_true",
                    help="run the whole MMA outer loop in FusedMMA")
    ap.add_argument("--solver", default="mgcg", choices=["jacobi", "mgcg"],
                    help="FEM linear solver (mgcg: multigrid-CG, ~5x "
                         "fewer iterations)")
    ap.add_argument("--cg-iters", type=int, default=None)
    ap.add_argument("-o", "--output", default=None)
    add_device(ap)
    args = ap.parse_args(argv)

    cg = args.cg_iters or (40 if args.solver == "mgcg" else 400)
    prob = FEMTopology(nex=args.nex, ney=args.ney, cg_iters=cg,
                       solver=args.solver, volume_fraction=0.4,
                       device=args.device)
    x0, _, _ = prob.get_vars_and_bounds()
    f0 = float(prob.objective(x0))

    t0 = time.time()
    if args.fused:
        solver = FusedMMA(prob, {
            "mma_max_iterations": args.iters, "mma_output_file": None,
            "abs_res_tol": 1e-4, "mma_l1_tol": 1e-30,
            "mma_linfty_tol": 1e-30, "max_major_iters": 50})
        res, _ = solver.solve()
    else:
        opt = Optimizer(prob, {
            "algorithm": args.algorithm,
            "output_file": None, "tr_output_file": None,
            "mma_output_file": "-",
            "mma_max_iterations": args.iters,
            "tr_max_iterations": args.iters,
            "max_major_iters": 300,
            "abs_res_tol": 1e-5,
        })
        res = opt.optimize()
    dt = time.time() - t0
    slack = float(prob.constraints(res["x"])[0])
    print(f"\ncompliance: {f0:.4f} -> {res['fobj']:.4f} "
          f"({100 * (1 - res['fobj'] / f0):.1f}% reduction), "
          f"volume slack {slack:+.4f}, wall {dt:.1f}s")

    plt = pyplot() if args.output else None
    if plt is not None:
        xf = host(prob._filter(res["x"]))
        fig, ax = plt.subplots(figsize=(8, 4))
        ax.imshow(xf.reshape(args.nex, args.ney).T[::-1], cmap="gray_r",
                  interpolation="nearest")
        ax.set_title(f"SIMP cantilever {args.nex}x{args.ney} "
                     f"({args.algorithm}); compliance "
                     f"{res['fobj'] / prob.c_scale:.3f}")
        ax.axis("off")
        fig.tight_layout()
        fig.savefig(args.output, dpi=140)
        print(f"wrote {args.output}")
    return {"f0": f0, "fobj": float(res["fobj"]), "slack": slack,
            "niter": res["niter"]}


if __name__ == "__main__":
    main()
