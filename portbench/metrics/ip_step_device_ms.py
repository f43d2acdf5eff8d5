"""ip_step_device_ms: device busy time per IP step in the profiled solve
(device trace)."""


def read(run, part, traffic):
    tr = run.trace
    steps = tr.units.get("ip_steps") if tr else None
    return tr.busy_s / steps * 1e3 if steps and tr.busy_s > 0 else None
