"""Frequency-constrained SIMP topology optimization via the compact
eigenvalue-approximation trust region (examples/fem_frequency.py on the
port).

    min   mass(x)
    s.t.  KS min natural frequency >= freq_fraction * lam1(full material)

Usage:  python -m paropt_torch.examples.fem_frequency [--nex 32 --ney 16 --N 6]
        python -m paropt_torch.examples.fem_frequency --nez 16 --nex 32 --ney 16
        (any --nez > 0 switches to the 3-D voxel model FrequencyTopology3D)

``--mode fused`` (default) runs `eig_fused.FusedEigenTR`; ``--mode host``
the reference-style EigenSubproblem under the host TrustRegion, which
writes its log to fem_frequency.tr in the working directory.
"""

import argparse
import time

import numpy as np

from ..models.fem_frequency import FrequencyTopology, FrequencyTopology3D
from ..tr import TrustRegion
from ._common import add_device


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nex", type=int, default=32)
    ap.add_argument("--ney", type=int, default=16)
    ap.add_argument("--nez", type=int, default=0,
                    help="> 0: 3-D voxel model (FrequencyTopology3D)")
    ap.add_argument("--N", type=int, default=6)
    ap.add_argument("--freq-fraction", type=float, default=0.5)
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--cg-iters", type=int, default=None)
    ap.add_argument("--solver", default="mgcg", choices=["jacobi", "mgcg"])
    ap.add_argument("--mode", default="fused", choices=["fused", "host"],
                    help="fused: the whole eigen-TR outer loop in "
                         "eig_fused.FusedEigenTR; host: the reference-style "
                         "EigenSubproblem + host TrustRegion")
    add_device(ap)
    args = ap.parse_args(argv)

    cg = args.cg_iters or (40 if args.solver == "mgcg" else 300)
    # (non-coarsenable odd meshes fall back to Jacobi automatically)
    if args.nez > 0:
        prob = FrequencyTopology3D(nex=args.nex, ney=args.ney,
                                   nez=args.nez, N=args.N,
                                   solver=args.solver,
                                   freq_fraction=args.freq_fraction,
                                   cg_iters=cg, device=args.device)
    else:
        prob = FrequencyTopology(nex=args.nex, ney=args.ney, N=args.N,
                                 solver=args.solver,
                                 freq_fraction=args.freq_fraction,
                                 cg_iters=cg, device=args.device)

    opts = {"tr_output_file": "fem_frequency.tr", "output_file": None,
            "tr_max_iterations": args.iters, "tr_init_size": 0.05,
            "tr_max_size": 0.2, "tr_min_size": 1e-6, "abs_res_tol": 1e-8,
            "tr_l1_tol": 1e-4, "tr_linfty_tol": 1e-4,
            "tr_adaptive_gamma_update": True, "penalty_gamma": 10.0}
    if args.nez > 0:
        # criterion scale at large n: the mass objective's gradient is
        # 1/n per entry, so the reference-normalized linfty KKT error
        # (computeKKTError, ParOptTrustRegion.cpp:2465-2472) starts below
        # 1e-4 whenever n > 1e4 and multipliers are O(1); ||g||_1 = 1, so
        # the l1 criterion keeps its meaning at every mesh size
        opts["tr_linfty_tol"] = 0.0
        opts["tr_l1_tol"] = 1e-3
    t0 = time.time()
    if args.mode == "fused":
        opts["tr_output_file"] = None
        res, _ = prob.build_fused_tr(opts).solve()
    else:
        sub, eigh = prob.build_tr_subproblem(msub=10)
        res = TrustRegion(prob, opts, subproblem=sub).optimize()
    x = res["x"]
    freqs = prob.frequencies(x)
    mass = float(prob.fem._filter(x).mean())
    print("converged=%s  wall=%.1fs" % (res["converged"], time.time() - t0))
    print("mass: %.4f (from 1.0)" % mass)
    print("target freq: %.6e  achieved lowest: %s"
          % (np.sqrt(prob.lam_target), freqs))
    return {"converged": bool(res["converged"]), "niter": res["niter"],
            "mass": mass, "target": float(np.sqrt(prob.lam_target)),
            "freqs": np.asarray(freqs).tolist()}


if __name__ == "__main__":
    main()
