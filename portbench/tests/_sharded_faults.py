"""Rank programs of `portbench.jobs.ip_solves_sharded` with a fault planted
on one rank, for test_portbench_sharded.py:

    python -m portbench.tests._sharded_faults <fault> --spec F --rank r

- ``raise``: rank 2 raises as it draws the window's first start, while
  the other ranks go on into the solve;
- ``ulp``: rank 1 keeps each kept solve's ``mu`` one ulp higher than it
  computed it.
"""

import sys

import torch

from portbench.jobs import ip_solves_sharded as job


def main():
    fault, argv = sys.argv[1], sys.argv[2:]
    rank = int(argv[argv.index("--rank") + 1])
    if fault == "raise" and rank == 2:
        draw = job._draw

        def broken(*args):
            if args[5] == 0:
                raise RuntimeError("a fault planted on rank 2")
            return draw(*args)

        job._draw = broken
    elif fault == "ulp" and rank == 1:
        keep = job._keep

        def nudged(state):
            out = keep(state)
            mu = out["mu"]
            out["mu"] = torch.nextafter(mu, torch.full_like(mu, float("inf")))
            return out

        job._keep = nudged
    job.main(argv)


if __name__ == "__main__":
    main()
