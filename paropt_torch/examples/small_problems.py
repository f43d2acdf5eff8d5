"""Gallery of small 2-D demo problems (examples/small_problems.py on the
port): five classic nonconvex test objectives under the shared constraint
x0 + x1 >= 0.5, solved from random starting points with IP or TR,
optionally rendering the iterate paths over a contour carpet.

    python -m paropt_torch.examples.small_problems [--algorithm ip|tr] [-o gallery.png]
"""

import argparse

import numpy as np
import torch

from ..optimizer import Optimizer
from ..problem import Problem
from ._common import add_device, host, pyplot

OBJECTIVES = [
    ("convex quadratic",
     lambda x: 2 * x[0] ** 2 + 2 * x[1] ** 2 + x[0] * x[1]),
    ("quartic-quadratic",
     lambda x: x[0] ** 4 + x[1] ** 2 + 2 * x[0] * x[1] - x[0] - x[1]),
    ("double well",
     lambda x: x[0] ** 4 + x[1] ** 4 + 1 - x[0] ** 2 - x[1] ** 2),
    ("sine saddle",
     lambda x: -10 * x[0] ** 2 + 10 * x[1] ** 2 + 4 * torch.sin(x[0] * x[1])
     - 2 * x[0] + x[0] ** 4),
    ("rosenbrock",
     lambda x: 100 * (x[1] - x[0] ** 2) ** 2 + (1 - x[0]) ** 2),
]


class Demo2D(Problem):
    """min f(x)  s.t.  x0 + x1 - 0.5 >= 0,  x in [-3, 3]^2."""

    def __init__(self, fobj, x0, device=None):
        super().__init__(nvars=2, ncon=1)
        self._f = fobj
        self.kw = dict(dtype=torch.float64, device=device)
        self._x0 = torch.as_tensor(x0, **self.kw)
        self.x_hist = []

    def objective(self, x):
        return self._f(x)

    def constraints(self, x):
        return (x[0] + x[1] - 0.5).reshape(1)

    def get_vars_and_bounds(self):
        return (self._x0, torch.full((2,), -3.0, **self.kw),
                torch.full((2,), 3.0, **self.kw))

    def write_output(self, it, x):
        self.x_hist.append(host(x))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--algorithm", default="ip", choices=["ip", "tr"])
    ap.add_argument("--starts", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("-o", "--output", default=None)
    add_device(ap)
    args = ap.parse_args(argv)

    rng = np.random.default_rng(args.seed)
    results, out = [], {}
    for name, f in OBJECTIVES:
        runs = []
        for s in range(args.starts):
            x0 = -2.0 + 4.0 * rng.uniform(size=2)
            prob = Demo2D(f, x0, device=args.device)
            opt = Optimizer(prob, {
                "algorithm": args.algorithm, "output_file": None,
                "tr_output_file": None, "abs_res_tol": 1e-7,
                "write_output_frequency": 1,
                "max_major_iters": 300, "tr_max_iterations": 100})
            res = opt.optimize()
            runs.append((x0, host(res["x"]), prob.x_hist,
                         float(res["fobj"])))
        best = min(r[3] for r in runs)
        xbest = runs[int(np.argmin([r[3] for r in runs]))][1]
        print(f"{name:18s}: best f* = {best:12.6f} over {args.starts} starts"
              f"  (x* of best: {xbest.round(4)})")
        results.append((name, f, runs))
        out[name] = {"best": best, "x": xbest.tolist(),
                     "fobj": [r[3] for r in runs]}

    plt = pyplot() if args.output else None
    if plt is not None:
        fig, axes = plt.subplots(1, len(results),
                                 figsize=(4 * len(results), 4))
        g1, g2 = np.meshgrid(np.linspace(-4, 4, 120),
                             np.linspace(-3, 3, 120))
        for ax, (name, f, runs) in zip(np.atleast_1d(axes), results):
            r = host(f([torch.as_tensor(g1), torch.as_tensor(g2)]))
            levels = r.min() + np.linspace(0, 1, 60) ** 2 * (r.max() - r.min())
            ax.contour(g1, g2, r, levels, linewidths=0.5)
            ax.plot([-2.5, 3.0], [3.0, -2.5], "-k", lw=0.8)  # constraint
            for x0, xs, hist, _ in runs:
                h = np.array(hist) if hist else np.array([x0, xs])
                ax.plot(h[:, 0], h[:, 1], "-o", ms=2, lw=0.8)
                ax.plot([xs[0]], [xs[1]], "r*", ms=8)
            ax.set_title(name, fontsize=9)
            ax.set_xlim(-4, 4)
            ax.set_ylim(-3, 3)
        fig.tight_layout()
        fig.savefig(args.output, dpi=120)
        print(f"wrote {args.output}")
    return out


if __name__ == "__main__":
    main()
