"""outer_it_s: the window's seconds over its outer iterations (host clock;
the window ends at the first boundary after --seconds)."""


def read(run, part, traffic):
    n = run.units.get("outer_iterations")
    return run.window_s / n if n else None
