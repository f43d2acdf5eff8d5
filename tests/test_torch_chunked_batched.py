"""The chunked execution of the fused solvers, continued from
tests/test_torch_chunked.py (its problems, options and paropt_tpu
solvers), in float64:

- ``solve_batched`` of FusedMMA, FusedTR and FusedEigenTR (k = 2 starts,
  3 outer iterations) under ``chunk`` in {1, 2, 3, None} against
  paropt_tpu's batched solve with chunk None, and of FusedIP (k = 3 starts
  to its cap; neither package's takes a chunk): equal niter and converged
  flags, every state field within 1e-12 absolute.  JAX's batched view
  stalls on an int chunk once an instance converges before another
  (`utils.chunked.batch_reader`), so its one-call form is the reference;
- a solve resumed from ``state0`` (k = 3) stops at JAX's absolute cap (5)
  under the default and runs the cap more (to 8) under
  ``jit_loop=False``, in both packages, states within 1e-12; and a
  resumed default solve at its cap takes no step."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ._torch_parity import np_of
from .test_torch_chunked import (CHUNKS, FIELDS, IP_FIELDS, _assert_states,
                                 _build, _build_cap, _cap, _ip, _jax_solver,
                                 _set_cap)

torch.set_num_threads(1)


@pytest.mark.parametrize("kind", sorted(FIELDS))
def test_resume_follows_jax_rule(kind):
    """From a state at k = 3: the default stops at the absolute cap (5),
    ``jit_loop=False`` runs the cap more (to 8), in both packages."""
    jsolver, _ = _jax_solver(kind)
    tsolver, _ = _build(kind, "torch")
    try:
        for solver in (jsolver, tsolver):
            _set_cap(solver, kind, 3)
        _, js3 = jsolver.solve(chunk=None)
        _, ts3 = tsolver.solve(chunk=None)
        assert int(js3.k) == int(ts3.k) == 3
        for solver in (jsolver, tsolver):
            _set_cap(solver, kind, 5)
        for jit_loop, want in ((True, 5), (False, 8)):
            jres, jst = jsolver.solve(state0=js3, jit_loop=jit_loop,
                                      chunk=2)
            tres, tst = tsolver.solve(state0=ts3, jit_loop=jit_loop,
                                      chunk=2)
            assert tres["niter"] == jres["niter"] == want
            _assert_states(tst, jst, FIELDS[kind])
        # a resumed default solve at its cap takes no step
        _, tst = tsolver.solve(state0=ts3, chunk=None)
        assert tsolver.solve(state0=tst)[1] is tst
    finally:
        _set_cap(jsolver, kind, _build_cap(kind))


def _starts(x0, k=2, seed=4):
    rng = np.random.default_rng(seed)
    return np.clip(np.asarray(x0)[None, :] * rng.uniform(0.6, 1.4, (
        k, np.asarray(x0).shape[0])), 0.05, 0.95)


BATCH_CAP = 3             # outer iterations of the batched cases
_JAX_BATCH = {}


def _jax_batch(kind):
    if kind not in _JAX_BATCH:
        solver, _ = _jax_solver(kind)
        x0 = np_of(solver._state0.x if kind == "mma" else solver._state0.xk)
        xs = _starts(x0)
        _set_cap(solver, kind, BATCH_CAP)
        try:
            _JAX_BATCH[kind] = xs, solver.solve_batched(jnp.asarray(xs),
                                                        chunk=None)
        finally:
            _set_cap(solver, kind, _build_cap(kind))
    return _JAX_BATCH[kind]


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("kind", sorted(FIELDS))
def test_outer_solvers_batched_chunked_match_jax(kind, chunk):
    """k = 2 starts, BATCH_CAP outer iterations."""
    xs, (jres, jst) = _jax_batch(kind)
    solver, _ = _build(kind, "torch", _cap(kind, BATCH_CAP))
    res, st = solver.solve_batched(torch.tensor(xs), chunk=chunk)
    np.testing.assert_array_equal(res["niter"], jres["niter"])
    np.testing.assert_array_equal(res["converged"], jres["converged"])
    _assert_states(st, jst, FIELDS[kind])



def test_fused_ip_batched_matches_jax():
    """k = 3 starts to the cap in one call, as JAX's batched solve (which
    takes no chunk): each instance ends where JAX's does."""
    jf, jd, jx0, jq = _ip("jax")
    xs = np.stack([np.asarray(jx0) * s for s in (1.0, 0.5, 1.5)])
    js = jf.solve_batched(jnp.asarray(xs), jd, (), jq)
    tf, td, _, tq = _ip("torch")
    ts = tf.solve_batched(torch.tensor(xs), td, (), tq)
    assert ts.k.tolist() == np.asarray(js.k).tolist() == [12] * 3
    _assert_states(ts, js, IP_FIELDS)
