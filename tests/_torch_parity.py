"""Shared helpers for the paropt_torch parity tests.

The same inputs, made with numpy from a seed, go through a paropt_tpu
function and its paropt_torch counterpart; these helpers move states
between the two as numpy arrays and build the small random KKT cases."""

import dataclasses

import numpy as np
import pytest
import torch


def np_of(x):
    """numpy array of a torch tensor or JAX array (bfloat16 -> float32)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.numpy()
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        a = a.astype(np.float32)
    return a


def fields_of(obj):
    """A JAX dataclass state as the dict `paropt_torch.convert` takes:
    numpy arrays for the leaves, plain values for the static fields, nested
    dicts for nested states."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out[f.name] = fields_of(v)
        elif f.metadata.get("static") or v is None:
            out[f.name] = v
        else:
            out[f.name] = np.asarray(v)
    return out


def assert_close(got, want, rtol, atol=0.0, name=""):
    np.testing.assert_allclose(np_of(got), np_of(want), rtol=rtol, atol=atol,
                               err_msg=name)


def assert_fields_close(got, want, rtol, atol=0.0, names=None):
    """Field-for-field comparison of a port dataclass with a JAX one."""
    for f in dataclasses.fields(want):
        if names is not None and f.name not in names:
            continue
        b = getattr(want, f.name)
        if f.metadata.get("static") or b is None:
            continue
        a = getattr(got, f.name)
        if dataclasses.is_dataclass(b):
            assert_fields_close(a, b, rtol, atol)
        else:
            assert_close(a, b, rtol, atol, name=f.name)


@pytest.fixture
def cuda():
    """The CUDA device, or a skip: a CUDA kernel has no interpret mode, so
    its check against the plain version runs only on a card (chip_smoke.py
    runs the same checks at the main path's shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel runs only there")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# random KKT cases (numpy), one per sparse-Jacobian layout
# ---------------------------------------------------------------------------


def kkt_case(layout, nwblock=1, ncon=1, k=4, nwcon=64, seed=0):
    """numpy fields of a ProblemData and an IPVars strictly inside the
    bounds, with the sparse pattern of ``layout``."""
    rng = np.random.default_rng(seed)
    if layout == "blocked_t":
        n = k * nwcon
        cols = (np.arange(nwcon)[:, None] + np.arange(k)[None, :] * nwcon)
    elif layout == "blocked":
        n = k * nwcon
        cols = np.arange(n).reshape(nwcon, k)
    else:
        # general gather pattern; with nwblock > 1 the rows of one block
        # share their columns, so the Cw blocks have off-diagonal entries
        nblocks = nwcon // nwblock
        n = nblocks * k
        perm = rng.permutation(n).reshape(nblocks, k)
        cols = np.repeat(perm, nwblock, axis=0)
    cols = cols.astype(np.int32)
    pos = lambda *shape: rng.uniform(0.4, 1.6, shape)
    d = dict(
        g=rng.standard_normal(n), A=rng.standard_normal((ncon, n)),
        c=rng.standard_normal(ncon), cw=rng.standard_normal(nwcon),
        lb=np.full(n, -1.0), ub=np.full(n, 1.0),
        lb_mask=np.ones(n), ub_mask=np.ones(n),
        gamma_s=np.zeros(ncon), gamma_t=np.full(ncon, 1e3),
        gamma_sw=np.zeros(nwcon), gamma_tw=np.full(nwcon, 1e3),
        Aw_cols=cols, Aw_vals=rng.standard_normal((nwcon, k)),
        nwblock=nwblock, Aw_layout=layout)
    v = dict(x=rng.uniform(-0.5, 0.5, n), zl=pos(n), zu=pos(n),
             s=pos(ncon), t=pos(ncon), z=rng.standard_normal(ncon),
             zs=pos(ncon), zt=pos(ncon), sw=pos(nwcon), tw=pos(nwcon),
             zw=rng.standard_normal(nwcon), zsw=pos(nwcon), ztw=pos(nwcon))
    return d, v


def qd_inputs(K, k, nwcon, seed):
    """numpy operands of the quasi-definite apply: dinv, cwinv, vals_t
    ([k, nwcon]), bx [K, k, nwcon], bw [K, nwcon], with a well-conditioned
    Cw = C0 + Σ vals² dinv."""
    rng = np.random.default_rng(seed)
    dinv = rng.uniform(0.5, 2.0, (k, nwcon))
    vals = rng.standard_normal((k, nwcon))
    cwinv = 1.0 / (rng.uniform(0.5, 1.5, nwcon) + np.sum(vals ** 2 * dinv, 0))
    return (dinv, cwinv, vals, rng.standard_normal((K, k, nwcon)),
            rng.standard_normal((K, nwcon)))


def qn_pairs(n, count, seed=0):
    """(s, y) pairs with positive curvature for a QN history."""
    rng = np.random.default_rng(seed)
    pairs = []
    for _ in range(count):
        s = rng.standard_normal(n)
        pairs.append((s, 2.0 * s + 0.3 * rng.standard_normal(n)))
    return pairs
