"""host_reads_per_it.<part>: the solver's counted host reads
(`HostSyncs.count`) over the window, per iteration of the part's unit:
``solve``, per IP step; ``outer``, per outer iteration."""

UNITS = {"solve": "ip_steps", "outer": "outer_iterations"}


def read(run, part, traffic):
    n = run.units.get(UNITS[part])
    reads = run.units.get("host_reads")
    return reads / n if n and reads is not None else None
