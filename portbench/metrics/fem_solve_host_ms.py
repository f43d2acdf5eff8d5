"""fem_solve_host_ms: host time of the ``paropt.fem.solve`` ranges, per
state solve of the profiled sub-window (under the profiler)."""


def read(run, part, traffic):
    tr = run.trace
    n = tr.range_count.get("paropt.fem.solve") if tr else None
    secs = tr.range_host_s.get("paropt.fem.solve") if tr else None
    return secs / n * 1e3 if n and secs else None
