"""paropt_torch.ops.qn against paropt_tpu.ops.qn: update trajectories (the
skip / damped ladder, SR1, the scaled decorator, the accept gate, bf16
storage), the compact form and the product, from the same numpy pairs."""

import dataclasses
from functools import partial

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from paropt_tpu.ops import pallas_kernels as pk
from paropt_tpu.ops import qn as jqn
from paropt_torch import convert
from paropt_torch.ops import qn as tqn

from ._torch_parity import assert_close, fields_of, np_of

torch.set_num_threads(1)

M, N = 4, 512
# f64 compute: the same algebra with another summation order; the small
# Gram/compact matrices agree to ~1e-14 relative, the trajectory over a few
# updates to 1e-10
RTOL = 1e-10


def _sequence(seed=5):
    """(s, y, accept, z0) per update: curvature flips sign at update 2,
    update 3 is a rejected line-search step."""
    rng = np.random.default_rng(seed)
    diag = 0.5 + rng.uniform(size=N)
    out = []
    for i in range(M + 3):
        s = rng.standard_normal(N)
        y = diag * s + 0.05 * rng.standard_normal(N)
        if i == 2:
            y = -y
        accept = None if i % 2 == 0 else (i != 3)
        out.append((s, y, accept, 1.0 + 0.5 * i))
    return out


def _run_pair(qn_type, update_type, storage):
    jst = jqn.qn_init(M, N, dtype=jnp.float64, qn_type=qn_type,
                      update_type=update_type,
                      storage_dtype=jnp.bfloat16 if storage else None)
    tst = tqn.qn_init(M, N, dtype=torch.float64, qn_type=qn_type,
                      update_type=update_type,
                      storage_dtype=torch.bfloat16 if storage else None)
    steps = []
    for s, y, accept, z0 in _sequence():
        jz0 = z0 if qn_type == "scaled_bfgs" else None
        jst, jskip, jdamp = jqn.qn_update(
            jst, jnp.asarray(s), jnp.asarray(y), z0=jz0,
            accept=None if accept is None else jnp.asarray(accept))
        tst, tskip, tdamp = tqn.qn_update(
            tst, torch.as_tensor(s), torch.as_tensor(y), z0=jz0,
            accept=None if accept is None else torch.tensor(accept))
        steps.append((jst, tst, (int(jskip), int(jdamp)),
                      (int(tskip), int(tdamp))))
    return steps


CASES = [("bfgs", "skip_negative_curvature", False),
         ("bfgs", "damped_update", False),
         ("sr1", "skip_negative_curvature", False),
         ("scaled_bfgs", "skip_negative_curvature", False),
         ("bfgs", "skip_negative_curvature", True),
         ("bfgs", "damped_update", True),
         ("sr1", "skip_negative_curvature", True)]


@pytest.mark.parametrize("qn_type,update_type,bf16", CASES)
def test_qn_update_trajectory(qn_type, update_type, bf16):
    for jst, tst, jflags, tflags in _run_pair(qn_type, update_type, bf16):
        assert jflags == tflags
        assert int(jst.count) == int(tst.count)
        if bf16:
            # the stored pairs are the same bf16 numbers
            assert tst.buf.dtype == torch.bfloat16
            assert np.array_equal(np_of(tst.buf), np_of(jst.buf))
        else:
            assert_close(tst.buf, jst.buf, rtol=RTOL, atol=1e-12)
        for name in ("SS", "SY", "b0", "z0"):
            assert_close(getattr(tst, name), getattr(jst, name), rtol=RTOL,
                         atol=1e-10, name=name)


@pytest.mark.parametrize("qn_type,update_type,bf16", CASES)
def test_qn_compact_and_mult(qn_type, update_type, bf16):
    jst, tst, _, _ = _run_pair(qn_type, update_type, bf16)[-1]
    jb0, jZ, jM = jqn.qn_compact(jst)
    tb0, tZ, tM = tqn.qn_compact(tst)
    assert_close(tb0, jb0, rtol=RTOL)
    assert_close(tZ, jZ, rtol=RTOL, atol=1e-12)
    assert_close(tM, jM, rtol=RTOL, atol=1e-10)
    x = np.random.default_rng(1).standard_normal(N)
    assert_close(tqn.qn_mult(tst, torch.as_tensor(x)),
                 jqn.qn_mult(jst, jnp.asarray(x)), rtol=1e-9, atol=1e-9)


def test_qn_state_converts_from_jax():
    """A JAX QN state arrives field for field through convert.qn_state and
    the next update agrees."""
    jst, _, _, _ = _run_pair("bfgs", "skip_negative_curvature", False)[3]
    tst = convert.qn_state(fields_of(jst))
    assert tst.qn_type == jst.qn_type and tst.msub == M
    for name in ("buf", "SS", "SY", "count", "b0", "z0"):
        assert np.array_equal(np_of(getattr(tst, name)),
                              np_of(getattr(jst, name)))
    s, y, _, _ = _sequence(seed=9)[0]
    jn, _, _ = jqn.qn_update(jst, jnp.asarray(s), jnp.asarray(y))
    tn, _, _ = tqn.qn_update(tst, torch.as_tensor(s), torch.as_tensor(y))
    assert_close(tn.SY, jn.SY, rtol=RTOL)


@pytest.mark.parametrize("qn_type,update_type,bf16", [
    ("bfgs", "skip_negative_curvature", False),
    ("sr1", "skip_negative_curvature", False),
    ("bfgs", "damped_update", True)])
def test_kernel_branch_matches_jax_pallas_branch(monkeypatch, qn_type,
                                                 update_type, bf16):
    """The port's kernel branch (taken on a CUDA buffer; here on the CPU,
    where the roll wrapper runs its plain version) against JAX's Pallas
    branch in interpret mode: both take the b0 scalars from the [2m, 2]
    dots.  f32 accumulation for bf16 storage: 1e-5."""
    monkeypatch.setattr(jqn, "_use_pallas_qn", lambda st: True)
    monkeypatch.setattr(pk, "qn_roll_update",
                        partial(pk.qn_roll_update, interpret=True))
    sdt_j = jnp.bfloat16 if bf16 else None
    sdt_t = torch.bfloat16 if bf16 else None
    jst = jqn.qn_init(M, N, qn_type=qn_type, update_type=update_type,
                      storage_dtype=sdt_j)
    tst = tqn.qn_init(M, N, qn_type=qn_type, update_type=update_type,
                      storage_dtype=sdt_t)
    rtol = 1e-5 if bf16 else RTOL
    for s, y, accept, _ in _sequence(seed=6):
        jst, jskip, _ = jqn.qn_update.__wrapped__(
            jst, jnp.asarray(s), jnp.asarray(y),
            accept=None if accept is None else jnp.asarray(accept))
        tst, tskip, _ = tqn._qn_update(
            tst, torch.as_tensor(s), torch.as_tensor(y), None, None,
            None if accept is None else torch.tensor(accept),
            kernel_branch=True)
        assert int(jskip) == int(tskip)
        assert np.array_equal(np_of(tst.buf), np_of(jst.buf))
        for name in ("SS", "SY", "b0"):
            assert_close(getattr(tst, name), getattr(jst, name), rtol=rtol,
                         atol=rtol, name=name)


def test_accept_false_is_identity():
    tst = tqn.qn_init(3, 64)
    rng = np.random.default_rng(9)
    for _ in range(2):
        s = torch.as_tensor(rng.standard_normal(64))
        tst, _, _ = tqn.qn_update(tst, s, 2.0 * s)
    s = torch.as_tensor(rng.standard_normal(64))
    new, skip, _ = tqn.qn_update(tst, s, 2.0 * s, accept=torch.tensor(False))
    assert int(skip) == 0
    for f in dataclasses.fields(tst):
        a, b = getattr(tst, f.name), getattr(new, f.name)
        assert (a == b) if isinstance(a, (str, bool)) else torch.equal(a, b)


def test_storage_policy_and_subspace_size():
    """No bf16 default on any device (an open H100 measurement); the
    qn_subspace_auto rule as in the JAX package."""
    assert tqn.default_storage_dtype(torch.float32) is None
    assert tqn.default_storage_dtype(torch.float64) is None
    for n in (1 << 12, 1 << 20):
        for tdt, jdt in ((torch.float32, jnp.float32),
                         (torch.float64, jnp.float64)):
            assert (tqn.resolve_subspace_size(10, True, n, tdt)
                    == jqn.resolve_subspace_size(10, True, n, jdt))
    assert tqn.resolve_subspace_size(10, False, 1 << 20, torch.float32) == 10
