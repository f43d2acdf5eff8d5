"""sync_idle_ms.solve: the device's idle time put down to
``paropt.host_read`` (the gaps that began while the host waited on a read
of a device value), per IP step of the profiled solve (under the profiler).

Nothing where the trace's kept idle-gap names (the largest ten) leave the
reads out, or the program has no such span: a missing name is not a zero."""

import sys

READ = "paropt.host_read"
UNITS = {"solve": "ip_steps"}


def read(run, part, traffic):
    tr = run.trace
    n = tr.units.get(UNITS.get(part)) if tr else None
    if not n:
        return None
    gaps = dict(tr.idle_gaps)
    if READ not in gaps:
        print(f"portbench: sync_idle_ms.{part} left out: {READ} is not "
              f"among the trace's {len(gaps)} kept idle-gap names",
              file=sys.stderr)
        return None
    return gaps[READ] / n * 1e3
