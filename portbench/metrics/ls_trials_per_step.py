"""ls_trials_per_step: the ``paropt.line_search_trial`` spans over the
``paropt.ip.step`` spans of the profiled sub-window: 1 where no step
backtracked."""


def read(run, part, traffic):
    tr = run.trace
    steps = tr.range_count.get("paropt.ip.step") if tr else None
    trials = tr.range_count.get("paropt.line_search_trial") if tr else None
    return trials / steps if steps and trials else None
