"""mma_inner_ip_ms: host time of the ``paropt.mma.inner_ip`` ranges per
outer iteration of the profiled sub-window (under the profiler)."""


def read(run, part, traffic):
    tr = run.trace
    n = tr.units.get("outer_iterations") if tr else None
    secs = tr.range_host_s.get("paropt.mma.inner_ip") if tr else None
    return secs / n * 1e3 if n and secs else None
