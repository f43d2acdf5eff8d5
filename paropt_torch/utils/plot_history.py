"""Convergence-history plots (counterpart of paropt_tpu/utils/
plot_history.py; the role of `paropt/plot_history.py`).

Parses the fixed-width optimizer logs (``paropt.out`` / ``paropt.tr`` /
``paropt.mma``) with the `unpack_*` parsers and draws a 2x2 grid of
convergence plots.  matplotlib is imported when a plot is drawn.  Usable
as a module or from the command line:

    python -m paropt_torch.utils.plot_history paropt.out [-o out.png]
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np

from .logging import unpack_mma_output, unpack_output, unpack_tr_output

__all__ = ["plot_history", "main"]

# log kind -> (parser, [(column, title, y scale)])
_SERIES = {
    "tr": (unpack_tr_output,
           [("fobj", "objective", "linear"),
            ("infeas", "infeasibility", "log"),
            ("linfty", "l-infinity optimality", "log"),
            ("tr", "trust region radius", "log")]),
    "mma": (unpack_mma_output,
            [("fobj", "objective", "linear"),
             ("infeas", "infeasibility", "log"),
             ("linfty", "l-infinity optimality", "log"),
             ("l1", "l1 optimality", "log")]),
    "ip": (unpack_output,
           [("fobj", "objective", "linear"),
            ("infes", "infeasibility", "log"),
            ("opt", "optimality", "log"),
            ("mu", "barrier parameter", "log")]),
}


def _detect_kind(path: str) -> str:
    if path.endswith(".tr"):
        return "tr"
    if path.endswith(".mma"):
        return "mma"
    return "ip"


def plot_history(path: str, output: Optional[str] = None, kind: str = "auto",
                 show: bool = False):
    """Plot a convergence history file; returns the matplotlib figure."""
    import matplotlib
    if not show:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    parse, series = _SERIES[_detect_kind(path) if kind == "auto" else kind]
    h = parse(path)
    fig, axes = plt.subplots(2, 2, figsize=(10, 7), sharex=True)
    it = h["iter"]
    for ax, (key, label, scale) in zip(axes.ravel(), series):
        vals = h[key]
        mask = np.isfinite(vals)
        if scale == "log":
            mask &= vals > 0
        ax.plot(it[mask], vals[mask], "-o", ms=2.5, lw=1.0)
        ax.set_yscale(scale)
        ax.set_title(label)
        ax.grid(True, alpha=0.3)
    for ax in axes[-1]:
        ax.set_xlabel("iteration")
    fig.suptitle(os.path.basename(path))
    fig.tight_layout()
    if output:
        fig.savefig(output, dpi=140)
    if show:
        plt.show()
    return fig


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("logfile")
    p.add_argument("-o", "--output", default=None)
    p.add_argument("--kind", default="auto",
                   choices=["auto", "ip", "tr", "mma"])
    args = p.parse_args(argv)
    out = args.output or (args.logfile + ".png")
    plot_history(args.logfile, output=out, kind=args.kind)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
