"""collective_device_ms: device time of the NCCL kernels of rank 0's
profiled solve, per IP step (device trace).  Every collective the solve
issues goes through the program's counter and its ``paropt.collective``
span; ``jobs/ip_solves_sharded._collective_device`` also reads the part
launched inside those spans, linked by correlation id, as a check of
that.  Nothing where the job reports no such time."""


def read(run, part, traffic):
    tr = run.trace
    steps = tr.units.get("ip_steps") if tr else None
    secs = tr.units.get("nccl_device_s") if tr else None
    return secs / steps * 1e3 if steps and secs else None
