"""Multi-material DMO truss (examples/dmo_truss.py on the port): the MMA
outer loop with per-bar weighting constraints.

    python -m paropt_torch.examples.dmo_truss [--device cpu]
"""

import argparse

from ..mma import MMA
from ..models.truss import DMOTruss
from ._common import add_device, host


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_device(ap)
    args = ap.parse_args(argv)
    prob = DMOTruss(nx=5, ny=3, device=args.device)
    mma = MMA(prob, {"mma_output_file": "-", "output_file": None,
                     "mma_max_iterations": 80})
    res = mma.optimize()
    w = host(res["x"]).reshape(prob.fem.nbars, prob.nmat)
    slack = float(prob.constraints(res["x"])[0])
    print(f"\ncompliance = {res['fobj']:.6e}  mass slack = {slack:.4f}")
    print("dominant material per bar:", w.argmax(axis=1))
    return {"fobj": float(res["fobj"]), "slack": slack,
            "niter": res["niter"], "dominant": w.argmax(axis=1).tolist()}


if __name__ == "__main__":
    main()
