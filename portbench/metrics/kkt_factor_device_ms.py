"""kkt_factor_device_ms: device time of the ops inside the
``paropt.kkt_factor`` range, per IP step of the profiled solve (device
trace)."""


def read(run, part, traffic):
    tr = run.trace
    steps = tr.units.get("ip_steps") if tr else None
    secs = tr.device_s("paropt.kkt_factor") if tr else None
    return secs / steps * 1e3 if steps and secs else None
