"""Eigenvalue-constraint trust-region optimization with the low-rank
compact approximation (examples/eigenvalue.py on the port).

A synthetic buckling-style constraint c(x) = r2 - |V'x|^2/2 >= 0 whose
exact Hessian is low-rank; the user callback refreshes the
CompactEigenApprox each accepted TR step.

    python -m paropt_torch.examples.eigenvalue [--device cpu]
"""

import argparse

import numpy as np
import torch

from ..eig import CompactEigenApprox, EigenQuasiNewton, EigenSubproblem
from ..ops import qn as qnmod
from ..problem import Problem
from ..tr import TrustRegion
from ._common import add_device


class BucklingStyleProblem(Problem):
    def __init__(self, n=32, N=3, r2=1.0, seed=0, device=None):
        super().__init__(nvars=n, ncon=1)
        rng = np.random.default_rng(seed)
        self.kw = dict(dtype=torch.float64, device=device)
        self.V = torch.as_tensor(rng.standard_normal((N, n)) / np.sqrt(n),
                                 **self.kw)
        self.N = N
        self.r2 = r2

    def objective(self, x):
        return torch.sum((x - 1.0) ** 2)

    def constraints(self, x):
        vx = self.V @ x
        return (self.r2 - 0.5 * torch.dot(vx, vx)).reshape(1)

    def get_vars_and_bounds(self):
        n = self.nvars
        return (torch.zeros(n, **self.kw), torch.full((n,), -10.0, **self.kw),
                torch.full((n,), 10.0, **self.kw))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_device(ap)
    args = ap.parse_args(argv)
    prob = BucklingStyleProblem(device=args.device)
    eigh = CompactEigenApprox(nvars=prob.nvars, N=prob.N, device=args.device)
    eqn = EigenQuasiNewton(qnmod.qn_init(10, prob.nvars, device=args.device),
                           eigh, index=0)
    sub = EigenSubproblem(prob, eqn)
    minus_eye = -torch.eye(prob.N, **prob.kw)

    def update_model(x, eigh):
        # exact low-rank curvature of the constraint: H = -V'V
        eigh.set_approximation(M=minus_eye, hvecs=prob.V)

    sub.set_eigen_model_update(update_model)
    x0, _, _ = prob.get_vars_and_bounds()
    f0, c0 = prob.eval_obj_con(x0)
    g0, A0 = prob.eval_obj_con_gradient(x0)
    eigh.set_approximation(c0=c0[0], g0=A0[0], M=minus_eye, hvecs=prob.V)

    tr = TrustRegion(prob, {
        "tr_output_file": "-", "output_file": None,
        "tr_max_iterations": 100, "tr_init_size": 1.0,
        "tr_adaptive_gamma_update": False,
    }, subproblem=sub)
    res = tr.optimize()
    con = float(prob.constraints(res["x"])[0])
    print(f"\nconverged: {res['converged']}  f* = {res['fobj']:.6e}")
    print(f"constraint: {con:.3e}")
    return {"converged": bool(res["converged"]),
            "fobj": float(res["fobj"]), "constraint": con,
            "niter": res["niter"]}


if __name__ == "__main__":
    main()
