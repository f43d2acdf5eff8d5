"""Maratos-effect demo (examples/maratos.py on the port): Nocedal & Wright
example 15.4, a quadratic on a circle (one equality constraint).  Near the
solution full steps along the linearized constraint increase both the
objective and the violation, so a filter (or an l1 merit) rejects them
and convergence crawls, unless the trust region's second-order correction
re-expands the constraint at the trial point.  The solvers write their
logs (paropt.tr, paropt.out) in the working directory.

    python -m paropt_torch.examples.maratos [--algorithm ip|tr] [--no-soc] [-o hist.png]
"""

import argparse

import numpy as np

from ..ip import InteriorPoint
from ..models.analytic import Maratos
from ..tr import TrustRegion
from ._common import add_device, host, pyplot


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--algorithm", default="tr", choices=["ip", "tr"])
    p.add_argument("--no-soc", action="store_true",
                   help="disable the second-order correction (shows the "
                        "Maratos effect: more rejected steps; tr only)")
    p.add_argument("-o", "--output", default=None,
                   help="render the iterate path over a contour plot")
    add_device(p)
    args = p.parse_args(argv)

    hist = []

    class TrackedMaratos(Maratos):
        def write_output(self, it, x):
            hist.append(host(x))

    prob = TrackedMaratos(device=args.device)
    prob.check_gradients()

    if args.algorithm == "tr":
        tr = TrustRegion(prob, {
            "tr_init_size": 1.0,
            "tr_min_size": 1e-6,
            "tr_max_size": 100.0,
            "tr_eta": 0.25,
            "penalty_gamma": 100.0,
            "tr_adaptive_gamma_update": False,
            "tr_accept_step_strategy": "filter_method",
            "tr_use_soc": not args.no_soc,
            "tr_max_iterations": 100,
            "tr_write_output_frequency": 1,
        })
        res = tr.optimize()
    else:
        if args.no_soc:
            p.error("--no-soc only applies to --algorithm tr (the "
                    "second-order correction is a trust-region device)")
        ip = InteriorPoint(prob, {"abs_res_tol": 1e-8,
                                  "write_output_frequency": 1})
        res = ip.optimize()

    x = host(res["x"])
    xstar = host(prob.solution())
    err = float(np.linalg.norm(x - xstar))
    print(f"converged: {res['converged']}  iters: {res['niter']}  "
          f"f* = {res['fobj']:.8f}")
    print(f"x  = {x}")
    print(f"x* = {xstar}  (error {err:.2e})")

    plt = pyplot() if args.output else None
    if plt is not None:
        g = np.linspace(-2.0, 2.0, 200)
        X, Y = np.meshgrid(g, g)
        F = 2.0 * (X - 0.5) ** 2 + 2.0 * Y ** 2
        fig, ax = plt.subplots()
        ax.contour(X, Y, F, levels=30, linewidths=0.5)
        th = np.linspace(0, 2 * np.pi, 200)
        ax.plot(np.sqrt(2) * np.cos(th), np.sqrt(2) * np.sin(th), "r-",
                label="c(x) = 0")
        if hist:
            h = np.asarray(hist)
            ax.plot(h[:, 0], h[:, 1], "b.-", ms=4, lw=0.8, label="iterates")
        ax.plot(*xstar, "k*", ms=12, label="x*")
        ax.set_aspect("equal", "box")
        ax.legend()
        fig.tight_layout()
        fig.savefig(args.output, dpi=120)
        print(f"wrote {args.output}")
    return {"converged": bool(res["converged"]), "niter": res["niter"],
            "fobj": float(res["fobj"]), "x": x.tolist(), "error": err,
            "writes": len(hist)}


if __name__ == "__main__":
    main()
