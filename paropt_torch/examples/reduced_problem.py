"""Reduced problem: optimize over a subset of the design variables
(examples/reduced_problem.py on the port).

    python -m paropt_torch.examples.reduced_problem [--device cpu]
"""

import argparse

import torch

from ..optimizer import Optimizer
from ..problem import Problem
from ..reduced import ReducedProblem
from ._common import add_device, host


class Quartic(Problem):
    """min x0^4 + x1^4 + x2^4  s.t.  x0 + x1 + x2 - 1 >= 0."""

    def __init__(self, device=None):
        super().__init__(nvars=3, ncon=1)
        self.kw = dict(dtype=torch.float64, device=device)

    def objective(self, x):
        return torch.sum(x ** 4)

    def constraints(self, x):
        return (torch.sum(x) - 1.0).reshape(1)

    def get_vars_and_bounds(self):
        return (torch.ones(3, **self.kw), torch.zeros(3, **self.kw),
                torch.full((3,), 10.0, **self.kw))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_device(ap)
    args = ap.parse_args(argv)
    full = Quartic(device=args.device)
    red = ReducedProblem(full, fixed_idx=[0], fixed_vals=[0.1])
    opt = Optimizer(red, {"algorithm": "tr", "output_file": None,
                          "tr_output_file": None, "tr_max_iterations": 200})
    res = opt.optimize()
    xfree = host(res["x"])
    xfull = red.expand(res["x"])
    con = float(full.constraints(xfull)[0])
    print(f"free solution: {xfree.round(5)}")
    print(f"full solution: {host(xfull).round(5)}  (x0 fixed at 0.1)")
    print(f"constraint: {con:+.2e}")
    return {"free": xfree.tolist(), "full": host(xfull).tolist(),
            "constraint": con, "niter": res["niter"]}


if __name__ == "__main__":
    main()
