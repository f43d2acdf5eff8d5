"""The native sparse Cholesky on its own (examples/cholesky.py on the
port): factor a 2-D Laplacian with natural and minimum-degree orderings
and compare the fill-in.  The factor runs on the host (the port's g++
build of src_native/paropt_sparse.cpp), so ``--device`` only names where
the right-hand side is made before it is copied there.

    python -m paropt_torch.examples.cholesky
"""

import argparse

import numpy as np
import torch

from ..ops import sparse_native as sn
from ._common import add_device, host


def laplacian_2d(nx):
    n = nx * nx
    rowp = [0]
    cols, vals = [], []
    for j in range(nx):
        for i in range(nx):
            row = j * nx + i
            entries = [(row, 4.0)]
            if i > 0:
                entries.append((row - 1, -1.0))
            if i < nx - 1:
                entries.append((row + 1, -1.0))
            if j > 0:
                entries.append((row - nx, -1.0))
            if j < nx - 1:
                entries.append((row + nx, -1.0))
            for c, v in sorted(entries):
                cols.append(c)
                vals.append(v)
            rowp.append(len(cols))
    return (n, np.asarray(rowp, np.int32), np.asarray(cols, np.int32),
            np.asarray(vals))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_device(ap)
    args = ap.parse_args(argv)
    out = []
    for nx in (16, 32, 64):
        n, rowp, cols, vals = laplacian_2d(nx)
        nat = sn.SparseCholesky(rowp, cols, ordering="natural")
        amd = sn.SparseCholesky(rowp, cols, ordering="amd")
        amd.factor(vals)
        b = host(torch.ones(n, dtype=torch.float64, device=args.device))
        x = amd.solve(b)
        # residual check
        r = np.zeros(n)
        for i in range(n):
            r[i] = sum(vals[p] * x[cols[p]]
                       for p in range(rowp[i], rowp[i + 1])) - b[i]
        print(f"nx={nx:3d} n={n:5d}  nnz(A)={rowp[-1]:7d}  "
              f"nnz(L) natural={nat.nnz:8d}  amd={amd.nnz:8d}  "
              f"fill ratio {nat.nnz / max(amd.nnz, 1):.2f}x  "
              f"|Ax-b|={np.abs(r).max():.2e}")
        out.append({"nx": nx, "nnz_natural": nat.nnz, "nnz_amd": amd.nnz,
                    "residual": float(np.abs(r).max())})
    return out


if __name__ == "__main__":
    main()
