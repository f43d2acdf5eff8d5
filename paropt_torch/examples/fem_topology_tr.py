"""SIMP compliance topology optimization with the fused trust region
(examples/fem_topology_tr.py on the port): the reference's default
algorithm on its flagship workload, the whole SL1QP outer loop (steering
infeasibility solves, fused-IP QP solves, trial FEM evaluations,
quasi-Newton updates, radius and adaptive penalties) in `tr.FusedTR`, in
windows sized by 'auto'.  Also k random starts as one batched solve
(`solve_batched`).  float32 on the card, float64 on the CPU, as the JAX
script.

    python -m paropt_torch.examples.fem_topology_tr --nex 24 --ney 12
"""

import argparse
import time

import numpy as np
import torch

from ..models.fem_topology import FEMTopology
from ..tr import FusedTR
from ._common import accelerator_dtype, add_device, host


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nex", type=int, default=24)
    ap.add_argument("--ney", type=int, default=12)
    ap.add_argument("--cg-iters", type=int, default=None)
    ap.add_argument("--solver", default="mgcg", choices=["jacobi", "mgcg"])
    ap.add_argument("--iters", type=int, default=40)
    ap.add_argument("--starts", type=int, default=4,
                    help="multi-start batch size (0 = single solve only)")
    add_device(ap)
    args = ap.parse_args(argv)
    dtype = accelerator_dtype(args.device)

    cg = args.cg_iters or (40 if args.solver == "mgcg" else 400)
    prob = FEMTopology(nex=args.nex, ney=args.ney, cg_iters=cg,
                       solver=args.solver, dtype=dtype, device=args.device)
    x0, _, _ = prob.get_vars_and_bounds()
    f0 = float(prob.objective(x0))
    opts = {"tr_output_file": None, "output_file": None,
            "tr_max_iterations": args.iters,
            "abs_res_tol": 1e-7, "tr_infeas_tol": 1e-5,
            "tr_l1_tol": 0.0, "tr_linfty_tol": 1e-4,
            "dtype": str(dtype).split(".")[-1]}
    solver = FusedTR(prob, opts)

    t0 = time.time()
    res, _ = solver.solve()
    print(f"TR: {res['niter']} outer iterations, compliance {f0:.4f} -> "
          f"{res['fobj']:.4f}, infeas {res['infeas']:.1e}, "
          f"linf {res['linfty']:.2e}, wall {time.time() - t0:.1f}s "
          f"(converged={res['converged']})")
    out = {"f0": f0, "niter": res["niter"], "fobj": float(res["fobj"]),
           "infeas": float(res["infeas"]), "linfty": float(res["linfty"]),
           "converged": bool(res["converged"])}

    if args.starts > 0:
        rng = np.random.default_rng(0)
        x0s = np.clip(host(x0)[None, :]
                      * rng.uniform(0.6, 1.4, (args.starts, prob.nvars)),
                      0.05, 0.95)
        t0 = time.time()
        resb, _ = solver.solve_batched(torch.as_tensor(x0s))
        best = int(np.argmin(resb["fobj"]))
        print(f"multi-start ({args.starts} batched solves, "
              f"{time.time() - t0:.1f}s): compliances "
              f"{np.round(resb['fobj'], 4)} — best start #{best} "
              f"({resb['fobj'][best]:.4f} vs uniform {res['fobj']:.4f})")
        out["batched_fobj"] = np.asarray(resb["fobj"]).tolist()
        out["batched_niter"] = np.asarray(resb["niter"]).tolist()
    return out


if __name__ == "__main__":
    main()
