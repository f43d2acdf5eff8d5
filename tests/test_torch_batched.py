"""`FusedIP.solve_batched`: k whole solves as one, held to the port's own
single solves and to paropt_tpu's batched solve on
`tests/test_batched.py`'s configuration (SyntheticTopology(256, block 8)
f64, in-loop L-BFGS msub 5, tol 1e-5, k = 3 starts from
``default_rng(0)``).

Tolerances: each instance against its own single solve, niter ±1, fobj
1e-9 relative, x 1e-6 relative / 1e-9 absolute (measured: equal niter,
fobj within 5e-16, x within 5e-12, the sums under vmap taken in another
order); against paropt_tpu, the same ``converged``, niter ±1 and fobj
1e-9 relative.  Each JAX result is computed once per module.
"""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paropt_tpu import ip_fused as jip
from paropt_tpu.models.topology import SyntheticTopology as JTopology
from paropt_tpu.ops import qn as jqn
from paropt_torch import convert
from paropt_torch import ip_fused as tip
from paropt_torch.models.topology import SyntheticTopology as TTopology
from paropt_torch.ops import qn as tqn
from paropt_torch.tree import bvmap, take, tmap

from ._torch_parity import fields_of

torch.set_num_threads(1)

N, K, MSUB, TOL = 256, 3, 5, 1e-5
F64 = torch.float64
SCALES = [1.0, 2.0, 4.0]


def _x0s(x0):
    rng = np.random.default_rng(0)
    return np.asarray(x0)[None, :] * rng.uniform(0.4, 1.6, size=(K, N))


@pytest.fixture(scope="module")
def jax_runs():
    """paropt_tpu's multi-start batch and its upper-bound sweep."""
    prob = JTopology(n=N, block=8, dtype=jnp.float64)
    opts = jip.FusedIPOptions(use_quasi_newton_update=True, abs_res_tol=TOL,
                              max_major_iters=400)
    fused = jip.FusedIP(jip.model_from_problem(prob), N, 1, prob.nwcon, 1,
                        opts, dtype=jnp.float64)
    data, x0 = jip.data_template_from_problem(prob, dtype=jnp.float64)
    qn0 = jqn.qn_init(MSUB, N, dtype=jnp.float64)
    st = fused.solve_batched(jnp.asarray(_x0s(x0)), data, (), qn0)
    scales = jnp.asarray(SCALES)
    data_b = dataclasses.replace(
        data, ub=scales[:, None] * jnp.asarray(data.ub)[None, :])
    axes = dataclasses.replace(
        jax.tree_util.tree_map(lambda _: None, data), ub=0)
    sweep = fused.solve_batched(jnp.broadcast_to(jnp.asarray(x0), (K, N)),
                                data_b, (), qn0, data_axes=axes)
    return ({"k": np.asarray(st.k), "fobj": np.asarray(st.fobj),
             "converged": np.asarray(st.converged),
             "state": fields_of(st)}, np.asarray(sweep.fobj))


def _port(**options):
    prob = TTopology(n=N, block=8, dtype=F64, device="cpu")
    opts = tip.FusedIPOptions(**dict(dict(use_quasi_newton_update=True,
                                          abs_res_tol=TOL,
                                          max_major_iters=400), **options))
    fused = tip.FusedIP(tip.model_from_problem(prob), N, 1, prob.nwcon, 1,
                        opts, dtype=F64)
    data, x0 = tip.data_template_from_problem(prob, dtype=F64)
    qn0 = tqn.qn_init(MSUB, N, dtype=F64, device="cpu")
    return fused, data, x0, qn0


def _no_fallback(fn, *args, **kwargs):
    """fn(...) with PyTorch's warning that vmap fell back to a
    per-instance loop (an op without a batching rule) made an error."""
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=".*batching rule.*")
        return fn(*args, **kwargs)


@pytest.fixture(scope="module")
def port_batch():
    fused, data, x0, qn0 = _port()
    x0s = torch.as_tensor(_x0s(x0.numpy()))
    return fused, data, qn0, x0s, _no_fallback(fused.solve_batched, x0s,
                                                data, (), qn0)


def test_multistart_matches_single_solves_and_paropt_tpu(port_batch,
                                                         jax_runs):
    fused, data, qn0, x0s, st = port_batch
    assert st.vars.x.shape == (K, N)
    assert bool(torch.all(st.converged))
    assert float(torch.max(st.res_norm)) < TOL
    for i in range(K):
        single = fused.solve(x0s[i], data, (), qn0)
        assert bool(single.converged)
        assert abs(int(st.k[i]) - int(single.k)) <= 1
        np.testing.assert_allclose(float(st.fobj[i]), float(single.fobj),
                                   rtol=1e-9)
        np.testing.assert_allclose(st.vars.x[i].numpy(),
                                   single.vars.x.numpy(), rtol=1e-6,
                                   atol=1e-9)
    jst, _ = jax_runs
    np.testing.assert_array_equal(st.converged.numpy(), jst["converged"])
    assert np.all(np.abs(st.k.numpy() - jst["k"]) <= 1)
    np.testing.assert_allclose(st.fobj.numpy(), jst["fobj"], rtol=1e-9)


def test_data_sweep_over_the_upper_bound(jax_runs):
    """``data_axes`` sweeps ``ub`` (scales 1, 2, 4): a looser box gives no
    worse objective, as paropt_tpu's sweep does, and the middle instance
    matches its own single solve."""
    fused, data, x0, qn0 = _port()
    scales = torch.tensor(SCALES, dtype=F64)
    data_b = dataclasses.replace(data, ub=scales[:, None] * data.ub[None, :])
    axes = dataclasses.replace(tmap(lambda _: None, data), ub=0)
    st = fused.solve_batched(x0.expand(K, N), data_b, (), qn0,
                             data_axes=axes)
    assert bool(torch.all(st.converged))
    f = st.fobj.numpy()
    assert f[1] <= f[0] + 1e-10 and f[2] <= f[1] + 1e-10
    _, jfobj = jax_runs
    np.testing.assert_allclose(f, jfobj, rtol=1e-9)
    single = fused.solve(x0, dataclasses.replace(data, ub=2.0 * data.ub), (),
                         qn0)
    np.testing.assert_allclose(f[1], float(single.fobj), rtol=1e-9)


def test_converged_instance_and_done_line_search_keep_their_carry(
        port_batch):
    """An instance that is converged keeps its whole state bit for bit
    while the others step, and a line search that is done keeps its carry
    bit for bit while the others' trial runs."""
    fused, data, qn0, x0s, done = port_batch
    fresh = bvmap(lambda x: fused.init(x, data, (), qn0, None), (0,), x0s)
    # instance 0 converged (from the finished batch), 1 and 2 starting
    state = tmap(lambda a, b: torch.cat([a[:1], b[1:]]), done, fresh)
    run = tip._Run(fused.syncs, batched=True)
    out = tip._fused_solve_loop(fused.model, fused.opts, state, data, (),
                                None, fused.syncs, max_iters=3, run=run)
    for a, b in zip(torch.utils._pytree.tree_leaves(take(out, 0)),
                    torch.utils._pytree.tree_leaves(take(state, 0))):
        assert torch.equal(a, b)
    assert out.k.tolist()[1:] == [3, 3]

    # one line-search trial with instance 0's search already done
    head = run.call(lambda s: tip._step_head(fused.model, fused.opts, s,
                                             data, (), None), (0,), fresh)
    p, _ = run.call(lambda s, h: tip._step_qn(fused.opts, s, data, h),
                    (0, 0), fresh, head)
    mer = run.call(lambda s, h, q: tip._step_merit(fused.opts, s, data, h,
                                                   q), (0, 0, 0), fresh,
                   head, p)
    ls0 = run.call(tip._ls_start, (0, 0), fresh,
                   torch.tensor([True, False, False]))
    ls1 = run.call(lambda s, h, m, c: tip._ls_trial(
        fused.model, fused.opts, s, data, (), h, m, c), (0, 0, 0, 0), fresh,
        head, mer, ls0)
    for a, b in zip(ls1, ls0):
        assert torch.equal(a[0], b[0])
    assert ls1.nev.tolist() == [0, 1, 1]


def test_newton_krylov_batch_matches_single_solves(monkeypatch):
    """NK (``use_hvec_product``) batched: instances that ask for an NK step
    take it, the others their QN step; each instance matches its own
    single solve."""
    nk_calls = []
    real_nk = tip._step_nk

    def counted(*args):
        nk_calls.append(1)
        return real_nk(*args)

    monkeypatch.setattr(tip, "_step_nk", counted)
    fused, data, x0, qn0 = _port(use_hvec_product=True,
                                 gmres_subspace_size=10,
                                 eisenstat_walker_gamma=0.05,
                                 nk_switch_tol=1e-3)
    rng = np.random.default_rng(1)
    x0s = x0[None] * torch.as_tensor(rng.uniform(0.4, 1.6, size=(2, N)))
    st = _no_fallback(fused.solve_batched, x0s, data, (), qn0)
    assert bool(torch.all(st.converged))
    assert nk_calls                  # the batch took NK steps
    for i in range(2):
        single = fused.solve(x0s[i], data, (), qn0)
        assert abs(int(st.k[i]) - int(single.k)) <= 1
        np.testing.assert_allclose(float(st.fobj[i]), float(single.fobj),
                                   rtol=1e-9)


def test_a_batched_paropt_tpu_state_converts_whole(port_batch, jax_runs):
    """`convert.fused_state` takes JAX's batched state as it is: every leaf
    keeps its leading k axis, instance i converts as JAX's instance i, and
    the port's batched loop carries the (converged) batch on unchanged."""
    fused, data, qn0, _, _ = port_batch
    jst = jax_runs[0]["state"]
    st = convert.fused_state(jst, device="cpu")
    assert st.vars.x.shape == (K, N) and st.qn.buf.shape == (K, 2 * MSUB, N)
    assert st.k.tolist() == jax_runs[0]["k"].tolist()
    one = convert.fused_state(
        torch.utils._pytree.tree_map(
            lambda a: a[1] if isinstance(a, np.ndarray) else a, jst),
        device="cpu")
    for a, b in zip(torch.utils._pytree.tree_leaves(take(st, 1)),
                    torch.utils._pytree.tree_leaves(one)):
        assert torch.equal(a, b)
    run = tip._Run(fused.syncs, batched=True)
    out = tip._fused_solve_loop(fused.model, fused.opts, st, data, (), None,
                                fused.syncs, max_iters=1, run=run)
    for a, b in zip(torch.utils._pytree.tree_leaves(out),
                    torch.utils._pytree.tree_leaves(st)):
        assert torch.equal(a, b)
