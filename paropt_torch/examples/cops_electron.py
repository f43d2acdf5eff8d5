"""COPS 3.0 'electrons on a sphere' (Thomson problem; examples/
cops_electron.py on the port): minimize the Coulomb potential of n point
charges constrained to the unit sphere (n equality constraints), in the
dense-constraint and the general-CSR sparse forms.

    python -m paropt_torch.examples.cops_electron [--n 20] [--csr] [--algorithm ip|tr]
"""

import argparse
import time

import numpy as np

from ..models.cops import Electron, ElectronCSR
from ..optimizer import Optimizer
from ._common import add_device, host


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=20, help="number of electrons")
    ap.add_argument("--csr", action="store_true",
                    help="general-CSR sparse-constraint form")
    ap.add_argument("--algorithm", default="ip", choices=["ip", "tr"])
    add_device(ap)
    args = ap.parse_args(argv)

    cls = ElectronCSR if args.csr else Electron
    prob = cls(n=args.n, device=args.device)
    opts = {"algorithm": args.algorithm, "output_file": None,
            "tr_output_file": None, "abs_res_tol": 1e-7,
            "max_major_iters": 500}
    t0 = time.time()
    opt = Optimizer(prob, opts)
    res = opt.optimize()
    x, z, zw, zl, zu = opt.get_optimized_point()
    xyz = host(x).reshape(3, args.n)
    radii = np.sqrt((xyz ** 2).sum(axis=0))
    f = float(prob.eval_obj_con(x)[0])
    violation = float(np.abs(radii - 1.0).max())
    print("form: %s  wall %.1fs" % ("CSR" if args.csr else "dense",
                                    time.time() - t0))
    print("potential energy: %.6f" % f)
    print("sphere violation: %.2e" % violation)
    return {"converged": bool(res["converged"]), "niter": res["niter"],
            "energy": f, "violation": violation}


if __name__ == "__main__":
    main()
