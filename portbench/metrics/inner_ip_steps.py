"""inner_ip_steps: the ``paropt.ip.step`` spans (the inner IP's steps) per
outer iteration of the profiled sub-window."""


def read(run, part, traffic):
    tr = run.trace
    n = tr.units.get("outer_iterations") if tr else None
    steps = tr.range_count.get("paropt.ip.step") if tr else None
    return steps / n if n and steps else None
