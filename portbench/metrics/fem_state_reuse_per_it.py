"""fem_state_reuse_per_it: the ``paropt.fem.state_reuse`` spans (gradients
that reused the state their objective evaluation solved) per outer
iteration of the profiled sub-window."""


def read(run, part, traffic):
    tr = run.trace
    n = tr.units.get("outer_iterations") if tr else None
    reuses = tr.range_count.get("paropt.fem.state_reuse") if tr else None
    return reuses / n if n and reuses else None
