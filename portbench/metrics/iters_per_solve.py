"""iters_per_solve: the mean count of IP steps of the window's solves,
each design's final k."""


def read(run, part, traffic):
    its = run.per_design_iters
    return sum(its) / len(its) if its else None
