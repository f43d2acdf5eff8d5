"""paropt_torch.ops.veclib, paropt_torch.problem and the small state
constructors against their paropt_tpu counterparts, on the same numpy
inputs in f64.

Tolerances: 1e-13 relative for reductions and products (the same arithmetic
in another summation order); autodiff defaults (grad, jacrev, jvp of a vjp)
1e-12, since the two frameworks order the chain rule's sums differently."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paropt_tpu import problem as jprob
from paropt_tpu.models.topology import SyntheticTopology as JTopology
from paropt_tpu.ops import kkt as jkkt
from paropt_tpu.ops import qn as jqn
from paropt_tpu.ops import veclib as jvec
from paropt_torch import problem as tprob
from paropt_torch.models.topology import SyntheticTopology as TTopology
from paropt_torch.ops import kkt as tkkt
from paropt_torch.ops import qn as tqn
from paropt_torch.ops import veclib as tvec

from ._torch_parity import assert_close, assert_fields_close, kkt_case

torch.set_num_threads(1)

RTOL = 1e-13


def _both(a):
    return jnp.asarray(a), torch.as_tensor(a)


@pytest.mark.parametrize("name", ["dot", "norm2", "l1norm", "maxabs", "mdot",
                                  "safe_div"])
def test_veclib_reductions(name):
    rng = np.random.default_rng(1)
    x = rng.standard_normal(300)
    y = rng.standard_normal(300)
    y[::7] = 1e-12                     # entries safe_div must guard
    ys = rng.standard_normal((4, 300))
    args = {"dot": (x, y), "norm2": (x,), "l1norm": (x,), "maxabs": (x,),
            "mdot": (ys, x), "safe_div": (x, y)}[name]
    kw = {"safe_div": dict(eps=1e-8)}.get(name, {})
    want = getattr(jvec, name)(*(jnp.asarray(a) for a in args), **kw)
    got = getattr(tvec, name)(*(torch.as_tensor(a) for a in args), **kw)
    assert_close(got, want, rtol=RTOL)


@pytest.mark.parametrize("norm_type", ["infinity", "l1", "l2"])
def test_norm_and_multi_norm(norm_type):
    rng = np.random.default_rng(2)
    parts = [rng.standard_normal(n) for n in (50, 0, 3, 17)]
    assert_close(tvec.norm(torch.as_tensor(parts[0]), norm_type),
                 jvec.norm(jnp.asarray(parts[0]), norm_type), rtol=RTOL)
    assert_close(tvec.multi_norm([torch.as_tensor(p) for p in parts],
                                 norm_type),
                 jvec.multi_norm([jnp.asarray(p) for p in parts], norm_type),
                 rtol=RTOL)
    empty = tvec.multi_norm([torch.zeros(0, dtype=torch.float64)], norm_type)
    assert empty.dtype == torch.float64 and float(empty) == 0.0
    with pytest.raises(ValueError):
        tvec.norm(torch.as_tensor(parts[0]), "l3")


@pytest.mark.parametrize("layout,nwblock", [("blocked_t", 1), ("blocked", 1),
                                            ("gather", 1), ("gather", 2)])
def test_sparse_jacobian_products(layout, nwblock):
    d, _ = kkt_case(layout, nwblock=nwblock, seed=3)
    n = d["g"].shape[0]
    jj = jprob.SparseJacobian(n, jnp.asarray(d["Aw_cols"]),
                              jnp.asarray(d["Aw_vals"]), nwblock=nwblock)
    tj = tprob.SparseJacobian(n, d["Aw_cols"], torch.as_tensor(d["Aw_vals"]),
                              nwblock=nwblock)
    assert tj.layout == jj.layout == layout
    rng = np.random.default_rng(4)
    px, zw, c = (rng.standard_normal(n), rng.standard_normal(tj.nwcon),
                 rng.uniform(0.5, 2.0, n))
    for method, arg in (("matvec", px), ("rmatvec", zw),
                        ("inner_product_blocks", c)):
        assert_close(getattr(tj, method)(torch.as_tensor(arg)),
                     getattr(jj, method)(jnp.asarray(arg)), rtol=RTOL,
                     atol=1e-15, name=method)


def _topologies(n=256):
    return (JTopology(n=n, block=8, dtype=jnp.float64),
            TTopology(n=n, block=8, dtype=torch.float64, device="cpu"))


def test_problem_autodiff_defaults():
    """grad/jacrev (eval_obj_con_gradient) and the Lagrangian Hessian-vector
    product (jvp of the grad and vjps) of the synthetic topology."""
    jp, tp = _topologies()
    rng = np.random.default_rng(5)
    x = rng.uniform(0.1, 0.9, tp.nvars)
    z, zw, px = (rng.standard_normal(1), rng.standard_normal(tp.nwcon),
                 rng.standard_normal(tp.nvars))
    jf, jc = jp.eval_obj_con(jnp.asarray(x))
    tf, tc = tp.eval_obj_con(torch.as_tensor(x))
    assert_close(tf, jf, rtol=RTOL)
    assert_close(tc, jc, rtol=RTOL)
    want = jp.eval_hvec_product(*(jnp.asarray(a) for a in (x, z, zw, px)))
    got = tp.eval_hvec_product(*(torch.as_tensor(a) for a in (x, z, zw, px)))
    assert_close(got, want, rtol=1e-12, atol=1e-15)


class _JNoJac(jprob.Problem):
    """A problem without a structured sparse Jacobian: the products fall
    back to autodiff of sparse_constraints."""

    def __init__(self):
        super().__init__(nvars=12, ncon=0, nwcon=4)

    def sparse_constraints(self, x):
        return jnp.sin(x[:4]) * x[4:8] ** 2 - x[8:]


class _TNoJac(tprob.Problem):
    def __init__(self):
        super().__init__(nvars=12, ncon=0, nwcon=4)

    def sparse_constraints(self, x):
        return torch.sin(x[:4]) * x[4:8] ** 2 - x[8:]


def test_sparse_products_fall_back_to_autodiff():
    rng = np.random.default_rng(6)
    x, px, zw = (rng.standard_normal(12), rng.standard_normal(12),
                 rng.standard_normal(4))
    jp, tp = _JNoJac(), _TNoJac()
    assert_close(tp.sparse_jacobian_vec(torch.as_tensor(x),
                                        torch.as_tensor(px)),
                 jp.sparse_jacobian_vec(jnp.asarray(x), jnp.asarray(px)),
                 rtol=1e-12)
    assert_close(tp.sparse_jacobian_tvec(torch.as_tensor(x),
                                         torch.as_tensor(zw)),
                 jp.sparse_jacobian_tvec(jnp.asarray(x), jnp.asarray(zw)),
                 rtol=1e-12)
    with pytest.raises(NotImplementedError):
        tp.eval_obj_con(torch.as_tensor(x))


def test_state_constructors():
    """zero_vars and qn_reset build the same fields as the JAX package."""
    assert_fields_close(tkkt.zero_vars(16, 2, 4, device="cpu"),
                        jkkt.zero_vars(16, 2, 4, dtype=jnp.float64),
                        rtol=0, atol=0)
    rng = np.random.default_rng(7)
    tq = tqn.qn_init(3, 16, dtype=torch.float64, device="cpu")
    jq = jqn.qn_init(3, 16, dtype=jnp.float64)
    for _ in range(2):
        s = rng.standard_normal(16)
        y = 2.0 * s + 0.1 * rng.standard_normal(16)
        tq = tqn.qn_update(tq, torch.as_tensor(s), torch.as_tensor(y))[0]
        jq = jqn.qn_update(jq, jnp.asarray(s), jnp.asarray(y))[0]
    assert int(tq.count) == 2
    assert_fields_close(tqn.qn_reset(tq), jqn.qn_reset(jq), rtol=0, atol=0)
