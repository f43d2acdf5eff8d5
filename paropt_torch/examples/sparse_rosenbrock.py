"""Rosenbrock with a sparse weighting constraint
(examples/sparse_rosenbrock.py on the port), with the interior point's
log on standard output.

    python -m paropt_torch.examples.sparse_rosenbrock [--device cpu]
"""

import argparse

from ..ip import InteriorPoint
from ..models.analytic import SparseRosenbrock
from ._common import add_device, host


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_device(ap)
    args = ap.parse_args(argv)
    prob = SparseRosenbrock(device=args.device)
    prob.check_gradients()
    ip = InteriorPoint(prob, {"abs_res_tol": 1e-7, "output_file": "-"})
    res = ip.optimize()
    print(f"\nconverged: {res['converged']}  f* = {res['fobj']:.8e}")
    print(f"x* = {host(res['x'])}")
    return {"converged": bool(res["converged"]), "fobj": float(res["fobj"]),
            "x": host(res["x"]).tolist(), "niter": res["niter"]}


if __name__ == "__main__":
    main()
