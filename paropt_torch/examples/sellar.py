"""Sellar problem (examples/sellar.py on the port): min x1^2 + x0 + x2 +
exp(-x3) s.t. x0 + x1 - 1 >= 0, the form of tests/test_examples.py, with
the interior point's log on standard output.

    python -m paropt_torch.examples.sellar [--device cpu]
"""

import argparse

import torch

from ..ip import InteriorPoint
from ..problem import Problem
from ._common import add_device, host


class Sellar(Problem):
    def __init__(self, device=None):
        super().__init__(nvars=4, ncon=1)
        self.kw = dict(dtype=torch.float64, device=device)

    def objective(self, x):
        return x[1] ** 2 + x[0] + x[2] + torch.exp(-x[3])

    def constraints(self, x):
        return (x[0] + x[1] - 1.0).reshape(1)

    def get_vars_and_bounds(self):
        x0 = torch.tensor([2.0, 1.0, 0.5, 0.5], **self.kw)
        lb = torch.tensor([0.1, -10.0, 0.0, 0.0], **self.kw)
        ub = torch.tensor([10.0, 10.0, 10.0, 10.0], **self.kw)
        return x0, lb, ub


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_device(ap)
    args = ap.parse_args(argv)
    ip = InteriorPoint(Sellar(device=args.device),
                       {"output_file": "-", "abs_res_tol": 1e-8})
    res = ip.optimize()
    print(f"\nconverged: {res['converged']}  f* = {res['fobj']:.8e}")
    print("x* =", host(res["x"]))
    return {"converged": bool(res["converged"]), "fobj": float(res["fobj"]),
            "x": host(res["x"]).tolist(), "niter": res["niter"]}


if __name__ == "__main__":
    main()
