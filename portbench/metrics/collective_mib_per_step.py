"""collective_mib_per_step: MiB of the local inputs rank 0 handed to its
collectives over the window (the program's counter), per IP step."""


def read(run, part, traffic):
    n = run.units.get("ip_steps")
    nbytes = run.units.get("collective_bytes")
    return nbytes / 2 ** 20 / n if n and nbytes is not None else None
