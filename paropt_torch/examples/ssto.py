"""SSTO lunar ascent by direct collocation (examples/ssto.py on the port;
the reference's dymos example): minimize the ascent time to a 185 km
lunar orbit under constant thrust with linear-tangent guidance.
Documented optimum t_f ~= 481 s.

    python -m paropt_torch.examples.ssto --nodes 40 [--device cpu]
"""

import argparse

import numpy as np

from ..ip import InteriorPoint
from ..models.ssto import SSTOCollocation
from ._common import add_device


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nodes", type=int, default=40)
    add_device(ap)
    args = ap.parse_args(argv)

    prob = SSTOCollocation(n_nodes=args.nodes, device=args.device)
    res = InteriorPoint(prob, {
        "output_file": None, "norm_type": "infinity",
        "qn_subspace_size": 10,
        "starting_point_strategy": "least_squares_multipliers",
        "qn_update_type": "damped_update", "abs_res_tol": 1e-6,
        "barrier_strategy": "monotone", "armijo_constant": 1e-5,
        "penalty_gamma": 100.0, "max_major_iters": 500}).optimize()
    tf = prob.final_time(res["x"])
    print(f"converged: {res['converged']}  t_f = {tf:.3f} s "
          f"(dymos-documented optimum ~481 s)")
    t, xs, ys, vx, vy, m, th = prob.trajectory(res["x"])
    print("t        x[km]    y[km]    vx      vy      theta(deg)")
    for i in range(0, prob.N, max(1, prob.N // 10)):
        print(f"{t[i]:7.1f} {xs[i]/1e3:8.1f} {ys[i]/1e3:8.1f} "
              f"{vx[i]:7.1f} {vy[i]:7.1f} {np.degrees(th[i]):8.2f}")
    return {"converged": bool(res["converged"]), "tf": tf,
            "niter": res["niter"]}


if __name__ == "__main__":
    main()
