"""Constrained Rosenbrock with each of the three algorithms
(examples/rosenbrock.py on the port).  The solvers write their logs
(paropt.out, paropt.tr, paropt.mma) in the working directory.

    python -m paropt_torch.examples.rosenbrock [--algorithm ip|tr|mma]
"""

import argparse

from ..models.analytic import Rosenbrock
from ..optimizer import Optimizer
from ._common import add_device, host


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--algorithm", default="tr", choices=["ip", "tr", "mma"])
    add_device(p)
    args = p.parse_args(argv)

    prob = Rosenbrock(device=args.device)
    prob.check_gradients()

    opt = Optimizer(prob, {
        "algorithm": args.algorithm,
        "qn_type": "bfgs",
        "qn_update_type": "damped_update",
        "tr_init_size": 0.5,
        "tr_min_size": 1e-6,
        "tr_max_size": 10.0,
        "tr_eta": 0.1,
        "tr_adaptive_gamma_update": True,
        "tr_max_iterations": 200,
    })
    res = opt.optimize()
    x, z, zw, zl, zu = opt.get_optimized_point()
    print(f"converged: {res['converged']}  f* = {res['fobj']:.8e}")
    print(f"x* = {host(x)}")
    return {"converged": bool(res["converged"]), "fobj": float(res["fobj"]),
            "x": host(x).tolist(), "niter": res["niter"]}


if __name__ == "__main__":
    main()
