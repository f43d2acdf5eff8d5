"""kernel_roofline: the bound of the port's custom-op calls in the
profiled sub-window (`roofline.call_bound_s` from each call's logged
shapes) over the device time of the kernels they launched, in percent.

Nothing where an op's calls could not be matched to the trace: a share
over a part of the kernels would read as the whole."""

import sys

from .. import roofline


def read(run, part, traffic):
    tr = run.trace
    if tr is None:
        return None
    if tr.unmatched:
        print("portbench: kernel_roofline left out: calls logged and traced "
              "differ for " + ", ".join(f"{op} ({n} logged, {m} traced)"
                                        for op, n, m in tr.unmatched),
              file=sys.stderr)
        return None
    calls = [c for c in tr.op_calls if c[3] > 0]
    if not calls:
        return None
    bound = sum(roofline.call_bound_s(name, dims, size)
                for name, dims, size, _ in calls)
    return 100.0 * bound / sum(c[3] for c in calls)
