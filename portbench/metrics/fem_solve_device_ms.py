"""fem_solve_device_ms: device time of the ops inside the
``paropt.fem.solve`` ranges, per state solve of the profiled sub-window
(device trace)."""


def read(run, part, traffic):
    tr = run.trace
    n = tr.range_count.get("paropt.fem.solve") if tr else None
    secs = tr.device_s("paropt.fem.solve") if tr else None
    return secs / n * 1e3 if n and secs else None
