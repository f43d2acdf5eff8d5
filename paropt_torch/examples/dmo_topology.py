"""Multi-material (DMO) 2-D topology design (examples/dmo_topology.py on
the port): choose between materials of different stiffness and weight per
element under a total mass cap.

    python -m paropt_torch.examples.dmo_topology [--nex 32 --ney 16] [-o design.png]
"""

import argparse
import time

import numpy as np

from ..ip import InteriorPoint
from ..models.fem_topology import DMOFEMTopology
from ._common import add_device, host, pyplot


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nex", type=int, default=32)
    ap.add_argument("--ney", type=int, default=16)
    ap.add_argument("--mass", type=float, default=0.3)
    ap.add_argument("-o", "--output", default=None)
    add_device(ap)
    args = ap.parse_args(argv)

    prob = DMOFEMTopology(nex=args.nex, ney=args.ney,
                          mass_fraction=args.mass, cg_iters=30,
                          solver="mgcg", device=args.device)
    t0 = time.time()
    ip = InteriorPoint(prob, {"output_file": None, "max_major_iters": 300,
                              "abs_res_tol": 1e-5})
    res = ip.optimize()
    x = host(res["x"])
    xm = x.reshape(prob.ne, prob.nmat)
    mass = float(np.mean(xm @ host(prob.rho_mats)))
    mats = prob.material_field(res["x"])
    print(f"converged={res['converged']} compliance(norm)="
          f"{float(res['fobj']):.5f} mass={mass:.4f} (cap {args.mass}) "
          f"wall={time.time() - t0:.1f}s")
    counts = {int(m): int((mats == m).sum()) for m in np.unique(mats)}
    print("material usage (-1 = void):", counts)

    plt = pyplot() if args.output else None
    if plt is not None:
        field = mats.reshape(args.nex, args.ney).T[::-1].astype(float)
        field[field < 0] = np.nan                      # void -> blank
        fig, ax = plt.subplots(figsize=(8, 4))
        im = ax.imshow(field, cmap="viridis", interpolation="nearest")
        ax.set_title(f"DMO {args.nex}x{args.ney}: material index per "
                     f"element (mass cap {args.mass})")
        ax.axis("off")
        fig.colorbar(im, ax=ax, shrink=0.75)
        fig.tight_layout()
        fig.savefig(args.output, dpi=140)
        print(f"wrote {args.output}")
    return {"converged": bool(res["converged"]), "niter": res["niter"],
            "fobj": float(res["fobj"]), "mass": mass, "counts": counts}


if __name__ == "__main__":
    main()
