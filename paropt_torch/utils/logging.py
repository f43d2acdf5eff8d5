"""Fixed-width optimizer logs and their parsers (counterpart of
paropt_tpu/utils/logging.py, which imports no jax; the port keeps its own
copy, as it does of the option registry).

The reference writes append-only fixed-width text logs — `paropt.out` for the
interior point method (15 columns + info flags, `ParOptInteriorPoint.cpp:
4777-4801`), `paropt.tr` for the trust region and `paropt.mma` for MMA — whose
layout is a guaranteed contract parsed by `unpack_output`/`unpack_tr_output`
(`paropt/ParOpt.pyx:61-232`).  This module reproduces that contract: a log
written by either package parses alike with either package's parsers.
"""

from __future__ import annotations

import io
from typing import Dict, List, Optional

import numpy as np

__all__ = ["IPLogger", "TRLogger", "MMALogger", "unpack_output",
           "unpack_tr_output", "unpack_tr_2nd_output", "unpack_mma_output"]


class _FileLogger:
    def __init__(self, path: Optional[str]):
        self.path = path
        self.fp = None
        if path == "-":
            import sys
            self.fp = sys.stdout
        elif path:
            self.fp = open(path, "w")

    def write(self, text: str) -> None:
        if self.fp is not None:
            self.fp.write(text)
            self.fp.flush()

    def close(self) -> None:
        if self.fp is not None and self.path != "-":
            self.fp.close()
            self.fp = None


class IPLogger(_FileLogger):
    """Interior-point iteration log with the reference's column layout."""

    HEADER = ("\n%4s %4s %4s %4s %7s %7s %7s %12s %7s %7s %7s "
              "%7s %7s %8s %7s info\n") % (
                  "iter", "nobj", "ngrd", "nhvc", "alpha", "alphx", "alphz",
                  "fobj", "|opt|", "|infes|", "|dual|", "mu", "comp",
                  "dmerit", "rho")

    def __init__(self, path, options_summary: str = ""):
        super().__init__(path)
        if options_summary:
            self.write(options_summary)

    def log(self, k: int, neval: int, ngeval: int, nhvec: int,
            alpha, alpha_x, alpha_z, fobj, opt_norm, infeas_norm, dual_norm,
            mu, comp, dmerit, rho, info: str = "",
            output_level: int = 0) -> None:
        if k % 10 == 0 or output_level > 0:
            self.write(self.HEADER)
        if k == 0:
            self.write(
                "%4d %4d %4d %4d %7s %7s %7s %12.5e %7.1e %7.1e "
                "%7.1e %7.1e %7.1e %8s %7s %s\n"
                % (k, neval, ngeval, nhvec, "--", "--", "--", fobj, opt_norm,
                   infeas_norm, dual_norm, mu, comp, "--", "--", info))
        else:
            self.write(
                "%4d %4d %4d %4d %7.1e %7.1e %7.1e %12.5e %7.1e "
                "%7.1e %7.1e %7.1e %7.1e %8.1e %7.1e %s\n"
                % (k, neval, ngeval, nhvec, alpha, alpha_x, alpha_z, fobj,
                   opt_norm, infeas_norm, dual_norm, mu, comp, dmerit, rho,
                   info))


class TRLogger(_FileLogger):
    """Trust-region iteration log (`paropt.tr` layout,
    `ParOptTrustRegion.cpp:1425-1440`)."""

    HEADER = ("\n%5s %12s %9s %9s %9s %9s %9s %9s %9s %9s %9s %9s %9s %9s "
              "%-12s\n") % (
                  "iter", "fobj", "infeas", "l1", "linfty", "|x - xk|", "tr",
                  "rho", "mod red.", "avg z", "max z", "avg pen.", "max pen.",
                  "time(s)", "info")

    def log(self, k, fobj, infeas, l1, linfty, smax, tr, rho, smodel, avg_z,
            max_z, avg_pen, max_pen, t, info: str = "") -> None:
        if k % 10 == 0:
            self.write(self.HEADER)
        self.write(
            "%5d %12.5e %9.2e %9.2e %9.2e %9.2e %9.2e %9.2e %9.2e %9.2e "
            "%9.2e %9.2e %9.2e %9.2e %-12s\n"
            % (k, fobj, infeas, l1, linfty, smax, tr, rho, smodel, avg_z,
               max_z, avg_pen, max_pen, t, info))


class MMALogger(_FileLogger):
    """MMA iteration log (`paropt.mma` layout, `ParOptMMA.cpp:584-591`)."""

    HEADER = "\n%5s %8s %15s %9s %9s %9s\n" % (
        "MMA", "sub-iter", "fobj", "l1-opt", "linft-opt", "l1-lambd")

    def log(self, k, subiter, fobj, l1, linfty, l1_lambda, infeas) -> None:
        if k % 10 == 0:
            self.write(self.HEADER[:-1] + " %9s\n" % "infeas")
        self.write("%5d %8d %15.6e %9.3e %9.3e %9.3e %9.3e\n"
                   % (k, subiter, fobj, l1, linfty, l1_lambda, infeas))


# ---------------------------------------------------------------------------
# parsers (role of ParOpt.pyx:61-232 unpack_output/unpack_tr_output)
# ---------------------------------------------------------------------------


def _parse_rows(path: str, ncols: int, int_cols) -> List[List[float]]:
    rows = []
    with open(path) as fp:
        for line in fp:
            parts = line.split()
            if len(parts) < ncols:
                continue
            try:
                int(parts[0])
            except ValueError:
                continue
            vals = []
            ok = True
            for j in range(ncols):
                tok = parts[j]
                if tok == "--":
                    vals.append(np.nan)
                    continue
                try:
                    vals.append(int(tok) if j in int_cols else float(tok))
                except ValueError:
                    ok = False
                    break
            if ok:
                rows.append(vals)
    return rows


def unpack_output(path: str) -> Dict[str, np.ndarray]:
    """Parse a `paropt.out`-format IP log into named numpy arrays
    (the role of `ParOpt.pyx:61-143 unpack_output`)."""
    names = ["iter", "nobj", "ngrd", "nhvc", "alpha", "alphx", "alphz",
             "fobj", "opt", "infes", "dual", "mu", "comp", "dmerit", "rho"]
    rows = _parse_rows(path, len(names), int_cols={0, 1, 2, 3})
    arr = np.asarray(rows, dtype=float) if rows else np.zeros((0, len(names)))
    return {name: arr[:, j] for j, name in enumerate(names)}


def unpack_tr_output(path: str) -> Dict[str, np.ndarray]:
    """Parse a `paropt.tr`-format TR log (`ParOpt.pyx:144-232`)."""
    names = ["iter", "fobj", "infeas", "l1", "linfty", "xnorm", "tr", "rho",
             "smodel", "avgz", "maxz", "avgpen", "maxpen", "time"]
    rows = _parse_rows(path, len(names), int_cols={0})
    arr = np.asarray(rows, dtype=float) if rows else np.zeros((0, len(names)))
    return {name: arr[:, j] for j, name in enumerate(names)}


def unpack_tr_2nd_output(path: str) -> Dict[str, np.ndarray]:
    """Parse the actual/predicted-reduction blocks a TR log contains at
    output_level > 0 (the `unpack_tr_2nd_output` contract,
    `ParOpt.pyx:208-246`): returns arrays for ared(f)/pred(f)/
    ared(c)/pred(c)."""
    names = ["ared(f)", "pred(f)", "ared(c)", "pred(c)"]
    content: Dict[str, list] = {n: [] for n in names}
    with open(path) as fp:
        lines = fp.readlines()
    for idx, line in enumerate(lines):
        if ("Model" in line and "ared(f)" in line and "pred(f)" in line
                and idx + 1 < len(lines)):
            data = lines[idx + 1].split()
            for j, n in enumerate(names):
                try:
                    content[n].append(float(data[j]))
                except (IndexError, ValueError):
                    content[n].append(0.0)
    return {n: np.asarray(v) for n, v in content.items()}


def unpack_mma_output(path: str) -> Dict[str, np.ndarray]:
    names = ["iter", "subiter", "fobj", "l1", "linfty", "l1lambda", "infeas"]
    rows = _parse_rows(path, len(names), int_cols={0, 1})
    arr = np.asarray(rows, dtype=float) if rows else np.zeros((0, len(names)))
    return {name: arr[:, j] for j, name in enumerate(names)}
