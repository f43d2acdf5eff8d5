"""solve_s: the window's seconds over the designs solved to tolerance in
it (host clock; the solve in flight at the window's end runs to its end
and counts)."""


def read(run, part, traffic):
    designs = run.units.get("designs")
    return run.window_s / designs if designs else None
