"""Brachistochrone by direct collocation (examples/brachistochrone.py on
the port; the reference's dymos example: (0, 10) -> (10, 5), v0 = 0,
g = 9.80665, theta in [0.01, 179.9] deg, converged final time 1.8016 s).

    python -m paropt_torch.examples.brachistochrone --nodes 48 [--device cpu]
"""

import argparse

import numpy as np

from ..ip import InteriorPoint
from ..models.brachistochrone import BrachistochroneCollocation
from ._common import add_device, host


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nodes", type=int, default=48)
    add_device(ap)
    args = ap.parse_args(argv)

    # the reference's dymos examples drive ParOpt with algorithm="ip";
    # the SL1QP trust region is not tuned for pure-equality collocation
    prob = BrachistochroneCollocation(n_nodes=args.nodes, device=args.device)
    opts = {
        "output_file": None, "norm_type": "infinity",
        "qn_subspace_size": 10,
        "starting_point_strategy": "least_squares_multipliers",
        "qn_update_type": "damped_update", "abs_res_tol": 1e-6,
        "barrier_strategy": "monotone", "armijo_constant": 1e-5,
        "penalty_gamma": 100.0, "max_major_iters": 500,
    }
    res = InteriorPoint(prob, opts).optimize()

    tf = float(res["fobj"])
    print(f"converged: {res['converged']}  tf = {tf:.6f} s "
          f"(dymos anchor 1.8016, rel err {abs(tf - 1.8016) / 1.8016:.1e})")
    t, xs, ys, vs, th = prob.trajectory(res["x"])
    d = host(prob._defects(res["x"]))
    print(f"max |defect| = {np.max(np.abs(d)):.2e}")
    print("t        x        y        v      theta(deg)")
    for i in range(0, prob.N, max(1, prob.N // 12)):
        print(f"{t[i]:7.4f} {xs[i]:8.4f} {ys[i]:8.4f} {vs[i]:8.4f} "
              f"{np.degrees(th[i]):8.2f}")
    return {"converged": bool(res["converged"]), "tf": tf,
            "niter": res["niter"], "max_defect": float(np.max(np.abs(d)))}


if __name__ == "__main__":
    main()
