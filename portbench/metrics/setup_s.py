"""setup_s: process start to the first timed instant (host clock)."""


def read(run, part, traffic):
    return run.setup_s
