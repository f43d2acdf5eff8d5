"""Cart-pole swing-up trajectory optimization (examples/cart_pole.py on the
port): the minimum-energy force history driving the pole from hanging at
rest to upright at rest.

    python -m paropt_torch.examples.cart_pole [--nsteps 63] [-o traj.png]
"""

import argparse
import time

import numpy as np

from ..models.cartpole import CartPole
from ..optimizer import Optimizer
from ._common import add_device, host, pyplot


def main(argv=None, max_iters=None):
    """Parse ``argv`` (the script's flags and ``--device``), solve, print
    and return the result.  ``max_iters`` (an argument of this function,
    not a flag of the script) caps the chosen algorithm's iterations."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nsteps", type=int, default=63)
    ap.add_argument("--algorithm", default="ip", choices=["ip", "tr", "mma"])
    ap.add_argument("-o", "--output", default=None)
    add_device(ap)
    args = ap.parse_args(argv)

    prob = CartPole(nsteps=args.nsteps, device=args.device)
    t0 = time.time()
    opts = {
        "algorithm": args.algorithm,
        "output_file": None, "tr_output_file": None,
        "max_major_iters": 500,
        "abs_res_tol": 1e-6,
        "init_barrier_param": 10.0,
        "starting_point_strategy": "least_squares_multipliers",
    }
    if max_iters is not None:
        opts[{"ip": "max_major_iters", "tr": "tr_max_iterations",
              "mma": "mma_max_iterations"}[args.algorithm]] = max_iters
    opt = Optimizer(prob, opts)
    res = opt.optimize()
    q = host(prob.trajectory(res["x"]))
    qf = q[-1]
    print(f"converged={res['converged']} fobj={float(res['fobj']):.6f} "
          f"wall={time.time() - t0:.1f}s")
    print(f"terminal state: x={qf[0]:+.5f} theta={qf[1]:+.5f} "
          f"xdot={qf[2]:+.2e} thetadot={qf[3]:+.2e} "
          f"(target 1, pi, 0, 0)")

    plt = pyplot() if args.output else None
    if plt is not None:
        t = host(prob.t)
        fig, ax = plt.subplots(3, 1, figsize=(7, 7), sharex=True)
        ax[0].plot(t, q[:, 0], label="x")
        ax[0].plot(t, q[:, 1], label="theta")
        ax[0].axhline(np.pi, color="k", ls=":", lw=0.7)
        ax[0].legend()
        ax[0].set_ylabel("position")
        ax[1].plot(t, q[:, 2], label="xdot")
        ax[1].plot(t, q[:, 3], label="thetadot")
        ax[1].legend()
        ax[1].set_ylabel("velocity")
        ax[2].step(t[:-1], host(res["x"]), where="post")
        ax[2].set_ylabel("force u")
        ax[2].set_xlabel("t")
        fig.tight_layout()
        fig.savefig(args.output, dpi=130)
        print(f"wrote {args.output}")
    return {"converged": bool(res["converged"]),
            "fobj": float(res["fobj"]), "niter": res["niter"],
            "terminal": qf.tolist()}


if __name__ == "__main__":
    main()
