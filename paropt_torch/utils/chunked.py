"""Chunked execution of the fused outer loops and their write-output
cadence (counterpart of paropt_tpu/utils/chunked.py).

The JAX package runs a fused solve as bounded ``lax.while_loop`` device
executions: ``run(state, k_stop)`` advances until ``converged`` or the
absolute count ``k_stop``, and `run_chunked` picks the windows and fires
``on_chunk`` at each boundary, the host-visible points where mid-solve
output and checkpoints live.  The port compiles nothing: each fused
solver's ``run`` is its host loop over eager steps, and `run_chunked` keeps
JAX's rule for the windows (the stop at the absolute ``max_it``, the
boundaries where hooks fire, the ``'auto'`` probe), so the final state is
the same under any chunk, bit for bit.  A CUDA graph per chunk, the true
counterpart of one device execution, is not built here.

The host reads of ``k`` and ``converged`` at the boundaries go through the
solver's ``read`` (one counted read per boundary), since on the card each
one waits for the device; ``run`` is handed the count just read,
``run(state, k, k_stop)``, so a window adds no read of its own to the
loop's per-step ``converged`` flag.
"""

from __future__ import annotations

import time

import torch

__all__ = ["AUTO_CHUNK_TARGET_S", "AUTO_CHUNK_MAX", "run_chunked",
           "run_chunked_batched", "step_until", "outer_loop", "host_reader", "batch_reader",
           "user_write_output", "make_write_output_hook"]

AUTO_CHUNK_TARGET_S = 10.0
AUTO_CHUNK_MAX = 64


def _values(syncs):
    if syncs is None:
        return lambda *ts: [float(t) for t in ts]
    return syncs.values


def host_reader(syncs=None):
    """``read(state) -> (k, converged)`` of a single solve: one host read
    of both scalars, counted by ``syncs`` (`ip.HostSyncs.values`)."""
    values = _values(syncs)

    def read(state):
        k, conv = values(state.k, state.converged)
        return int(k), bool(conv)
    return read


def batch_reader(syncs=None):
    """``read(state) -> (k, converged)`` of a batched state (leading
    instance axis): the least k among the instances still running and
    whether every instance has converged, in one host read, counted by
    ``syncs``.

    JAX's ``_BatchView`` takes the least k over all instances, converged
    ones too (paropt_tpu/utils/chunked.py:139-142); an instance that
    converged earlier then pins ``k_stop`` below the others' count, and an
    int chunk repeats that window for ever.  Where JAX's rule ends, both
    give the same windows."""
    values = _values(syncs)

    def read(state):
        conv = state.converged
        running = torch.where(conv, torch.iinfo(torch.int32).max,
                              state.k.to(torch.int32))
        k, done = values(running.min(), conv.all())
        return int(k), bool(done)
    return read


def _synchronize(state):
    dev = state.k.device
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_chunked(run, state, max_it: int, chunk="auto",
                target_s: float = AUTO_CHUNK_TARGET_S,
                chunk_max: int = AUTO_CHUNK_MAX, on_chunk=None, read=None):
    """Drive ``run(state, k, k_stop) -> state`` (the solver's loop: from a
    state whose count is ``k`` it steps until ``converged`` or the absolute
    count ``k_stop``; `step_until`) to ``max_it``
    outer iterations in windows of ``chunk`` (JAX's rule,
    paropt_tpu/utils/chunked.py:23-70).

    ``chunk``: a positive int (``k_stop = min(k + chunk, max_it)``), None
    (one call to ``max_it``) or ``'auto'`` (one outer iteration, then one
    timed outer iteration ending with a device synchronize, then windows of
    clamp(``target_s`` / seconds, 1, ``chunk_max``)).  ``on_chunk(state)``
    is called after every call.  ``read(state) -> (k, converged)`` reads
    the two scalars on the host (default `host_reader()`, uncounted).
    ``run`` is called only on a state that has not converged and
    is below its ``k_stop``, where JAX's ``while_loop`` would take a step;
    elsewhere the state passes through unchanged, as it does in JAX."""
    if chunk is not None and chunk != "auto" and int(chunk) < 1:
        raise ValueError(f"chunk must be a positive int, 'auto', or None; "
                         f"got {chunk!r}")
    read = read or host_reader()
    k, conv = read(state)

    def call(state, k, conv, k_stop):
        if not conv and k < k_stop:
            state = run(state, k, k_stop)
        if on_chunk is not None:
            on_chunk(state)
        return state

    if chunk == "auto":
        if k < max_it and not conv:
            state = call(state, k, conv, k + 1)
            _synchronize(state)
            k, conv = read(state)
        if k < max_it and not conv:
            t0 = time.perf_counter()
            state = run(state, k, k + 1)
            _synchronize(state)
            dt = max(time.perf_counter() - t0, 1e-6)
            chunk = int(max(1, min(chunk_max, target_s / dt)))
            if on_chunk is not None:
                on_chunk(state)
            k, conv = read(state)
        else:
            chunk = 1
    if chunk is None or chunk >= max_it:
        return call(state, k, conv, max_it)
    while True:
        state = call(state, k, conv, min(k + chunk, max_it))
        k, conv = read(state)
        if conv or k >= max_it:
            return state


def step_until(step, done, state, k: int, k_stop: int):
    """The loop of a ``run``: ``state = step(state)`` until ``done(state)``
    (one host read per step) or ``k_stop - k`` steps.  A step that does not
    converge advances the count by one in every fused solver, so the count
    is kept on the host."""
    for _ in range(k_stop - k):
        state = step(state)
        if done(state):
            break
    return state


def outer_loop(step, done, state, max_it: int, jit_loop: bool = True,
               chunk="auto", on_chunk=None, read=None):
    """The outer loop of ``FusedMMA.solve``, ``FusedTR.solve`` and
    ``FusedEigenTR.solve``: ``jit_loop`` runs `run_chunked` to the absolute
    count ``max_it``; otherwise ``max_it`` more steps from ``state``, with
    ``on_chunk`` after every step (JAX's ``jit_loop=False`` path)."""
    if jit_loop:
        return run_chunked(
            lambda s, k, k_stop: step_until(step, done, s, k, k_stop),
            state, max_it, chunk, on_chunk=on_chunk, read=read)

    def stepped(s):
        s = step(s)
        if on_chunk is not None:
            on_chunk(s)
        return s

    return step_until(stepped, done, state, 0, max_it)


def run_chunked_batched(run, state, max_it: int, chunk="auto",
                        on_chunk=None, read=None):
    """`run_chunked` over a batched state (every leaf has a leading
    instance axis; paropt_tpu/utils/chunked.py:150-158): ``run(state, k,
    k_stop)`` steps the instances still running (all at count ``k``), and ``read`` (default
    `batch_reader()`: the least k of the running instances and "every
    instance converged") paces the windows, one read per boundary.
    ``on_chunk`` receives the batched state."""
    return run_chunked(run, state, max_it, chunk, on_chunk=on_chunk,
                       read=read or batch_reader())


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
                           checkpoint_path=None, syncs=None):
    """An ``on_chunk(state)`` callback that fires ``write_output(it, x)``
    and writes the full state to ``checkpoint_path`` (`save_state`) at the
    first chunk boundary at or past each multiple of ``freq`` outer
    iterations (paropt_tpu/utils/chunked.py:90-121).  Each call reads
    ``state.k`` on the host, counted by ``syncs`` (`ip.HostSyncs`).
    Returns None when ``freq`` <= 0 or there is nothing to fire."""
    if freq is None or int(freq) <= 0:
        return None
    if write_output is None and checkpoint_path is None:
        return None          # nothing to fire: no read of state.k
    freq = int(freq)
    next_k = [0]
    read = float if syncs is None else syncs.value

    def hook(state):
        k = int(read(state.k))
        if k < next_k[0]:
            return
        next_k[0] = (k // freq + 1) * freq
        if write_output is not None:
            write_output(k, get_x(state))
        if checkpoint_path is not None:
            from .checkpoint import save_state
            save_state(checkpoint_path, state)

    return hook
