"""The write-output cadence of the fused solvers (counterpart of
paropt_tpu/utils/chunked.py:73-122).

The JAX package bounds each device execution of a fused loop in chunks and
fires the user's ``write_output`` hook at chunk boundaries.  The port's fused
loops are host loops, so the hook is called after every outer iteration and
fires at the first iteration at or past each multiple of
``write_output_frequency``; a ``checkpoint_path`` gets the full solver state
at the same cadence (`utils.checkpoint.save_state`).
"""

from __future__ import annotations

__all__ = ["user_write_output", "make_write_output_hook"]


def user_write_output(problem):
    """The problem's ``write_output`` bound method only if the problem
    overrides it.  The base ``Problem.write_output`` is a no-op, and a hook
    reads ``state.k`` on the host each time it is called, so returning None
    lets ``make_write_output_hook`` return no hook at all."""
    from ..problem import Problem
    if "write_output" in vars(problem):     # instance-assigned hook
        return problem.write_output
    fn = getattr(type(problem), "write_output", None)
    if fn is None or fn is Problem.write_output:
        return None
    return problem.write_output


def make_write_output_hook(write_output, freq, get_x=lambda st: st.xk,
                           checkpoint_path=None):
    """An ``on_chunk(state)`` callback that fires ``write_output(it, x)``
    and writes the full state to ``checkpoint_path`` (`save_state`) at the
    first call at or past each multiple of ``freq`` outer iterations.
    Returns None when ``freq`` <= 0 or there is nothing to fire."""
    if freq is None or int(freq) <= 0:
        return None
    if write_output is None and checkpoint_path is None:
        return None          # nothing to fire: no read of state.k
    freq = int(freq)
    next_k = [0]

    def hook(state):
        k = int(state.k)
        if k < next_k[0]:
            return
        next_k[0] = (k // freq + 1) * freq
        if write_output is not None:
            write_output(k, get_x(state))
        if checkpoint_path is not None:
            from .checkpoint import save_state
            save_state(checkpoint_path, state)

    return hook
