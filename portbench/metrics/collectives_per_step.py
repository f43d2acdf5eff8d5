"""collectives_per_step: the collectives rank 0 issued over the window
(the program's counter, `paropt_torch.parallel.collectives`), per IP
step."""


def read(run, part, traffic):
    n = run.units.get("ip_steps")
    calls = run.units.get("collectives")
    return calls / n if n and calls is not None else None
