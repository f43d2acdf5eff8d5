"""paropt_torch.ops.kkt against paropt_tpu.ops.kkt on random KKT cases of
every sparse layout (blocked_t, blocked, gather, and gather with nwblock 2),
with a populated compact QN term: the residual, the factor field for field,
the step with one refinement pass, the step lengths and the
complementarity.  On blocked_t the port's factor goes through the fused
route (`_setup_factor_fused`, the phi_gram kernel's plain version on the
CPU), held against JAX's default per-solve factor."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paropt_tpu.ops import kkt as jkkt
from paropt_tpu.ops import qn as jqn
from paropt_torch import convert
from paropt_torch.ops import kernels
from paropt_torch.ops import kkt as tkkt
from paropt_torch.ops import qn as tqn

from ._torch_parity import (assert_close, assert_fields_close, fields_of,
                            kkt_case, np_of, qn_pairs)

torch.set_num_threads(1)

CASES = [("blocked_t", 1, 1), ("blocked_t", 1, 3), ("blocked", 1, 2),
         ("gather", 1, 1), ("gather", 2, 1)]
IDS = [f"{lay}-nwblock{nb}-ncon{nc}" for lay, nb, nc in CASES]


def _build(layout, nwblock, ncon, msub=3):
    dnp, vnp = kkt_case(layout, nwblock, ncon, seed=len(layout) + ncon)
    jd = jkkt.ProblemData(**{k: (jnp.asarray(v) if isinstance(v, np.ndarray)
                                 else v) for k, v in dnp.items()})
    jv = jkkt.IPVars(**{k: jnp.asarray(v) for k, v in vnp.items()})
    td = convert.problem_data(fields_of(jd), device="cpu")
    tv = convert.ip_vars(fields_of(jv), device="cpu")
    n = jd.n
    jq = jqn.qn_init(msub, n)
    for s, y in qn_pairs(n, msub):
        jq, _, _ = jqn.qn_update(jq, jnp.asarray(s), jnp.asarray(y))
    tq = convert.qn_state(fields_of(jq), device="cpu")
    return jd, jv, td, tv, jqn.qn_compact(jq), tqn.qn_compact(tq)


@pytest.mark.parametrize("layout,nwblock,ncon", CASES, ids=IDS)
def test_kkt_residual(layout, nwblock, ncon):
    jd, jv, td, tv, _, _ = _build(layout, nwblock, ncon)
    mu = 0.05
    assert_fields_close(tkkt.kkt_residual(tv, td, mu, 0.5),
                        jkkt.kkt_residual(jv, jd, jnp.asarray(mu), 0.5),
                        rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("layout,nwblock,ncon", CASES, ids=IDS)
def test_setup_kkt_factor_field_for_field(layout, nwblock, ncon,
                                          monkeypatch):
    """Every KKTFactor field.  The fused route forms Gmat, the SMW
    right-hand sides and Ce from one Gram matrix instead of separate
    solves and products: the same algebra reassociated, held to 1e-9 as
    tests/test_pallas.py holds JAX's own fused route; the per-solve route
    mirrors JAX's operation order (1e-11)."""
    calls = []
    orig = kernels.phi_gram
    monkeypatch.setattr(kernels, "phi_gram",
                        lambda *a: calls.append(1) or orig(*a))
    jd, jv, td, tv, jcq, tcq = _build(layout, nwblock, ncon)
    jf = jkkt.setup_kkt_factor(jv, jd, qn_compact=jcq)
    tf = tkkt.setup_kkt_factor(tv, td, qn_compact=tcq)
    fused = layout == "blocked_t"
    assert len(calls) == (1 if fused else 0)
    tol = 1e-9 if fused else 1e-11
    assert_fields_close(tf, jf, rtol=tol, atol=tol,
                        names=("Dinv", "Gamma", "C0", "Cw_chol", "Xa", "Wa",
                               "Zqn", "Phi_x", "Phi_z", "Phi_w", "Ce_inv"))
    if ncon <= 2:
        assert_close(tf.G_lu, jf.G_lu, rtol=tol, atol=tol)
    else:
        # LU with partial pivoting; JAX's pivots are 0-based, torch's 1-based
        assert_close(tf.G_lu[0], jf.G_lu[0], rtol=tol, atol=tol)
        assert np.array_equal(np_of(tf.G_lu[1]) - 1, np_of(jf.G_lu[1]))


@pytest.mark.parametrize("layout,nwblock,ncon", CASES, ids=IDS)
def test_solve_kkt_with_refinement(layout, nwblock, ncon):
    """The full Newton step p with one refinement pass, and the KKT matrix
    applied to it reproduces -r (1e-9: the factor's tolerance, above)."""
    jd, jv, td, tv, jcq, tcq = _build(layout, nwblock, ncon)
    jr = jkkt.kkt_residual(jv, jd, jnp.asarray(0.1), 1.0)
    tr = tkkt.kkt_residual(tv, td, 0.1, 1.0)
    jp = jkkt.solve_kkt(jv, jd, jkkt.setup_kkt_factor(jv, jd, qn_compact=jcq),
                        jr, refine_steps=1, qn_compact=jcq)
    tp = tkkt.solve_kkt(tv, td, tkkt.setup_kkt_factor(tv, td, qn_compact=tcq),
                        tr, refine_steps=1, qn_compact=tcq)
    assert_fields_close(tp, jp, rtol=1e-9, atol=1e-9)
    Kp = tkkt.apply_kkt_matrix(tv, td, tp, qn_compact=tcq)
    for name in ("x", "zl", "zu", "z", "zw", "sw", "zsw"):
        assert_close(getattr(Kp, name), -getattr(tr, name), rtol=1e-8,
                     atol=1e-8, name=name)


@pytest.mark.parametrize("layout,nwblock,ncon", CASES[:2] + CASES[3:4],
                         ids=IDS[:2] + IDS[3:4])
def test_step_lengths_and_complementarity(layout, nwblock, ncon):
    jd, jv, td, tv, jcq, tcq = _build(layout, nwblock, ncon)
    jr = jkkt.kkt_residual(jv, jd, jnp.asarray(0.0), 1.0)
    tr = tkkt.kkt_residual(tv, td, 0.0, 1.0)
    jp = jkkt.solve_kkt(jv, jd, jkkt.setup_kkt_factor(jv, jd, qn_compact=jcq),
                        jr)
    tp = tkkt.solve_kkt(tv, td, tkkt.setup_kkt_factor(tv, td, qn_compact=tcq),
                        tr)
    for tau in (0.95, 0.995):
        for got, want in zip(tkkt.max_step_lengths(tv, td, tp, tau),
                             jkkt.max_step_lengths(jv, jd, jp, tau)):
            assert_close(got, want, rtol=1e-9)
    assert_close(tkkt.average_complementarity(tv, td),
                 jkkt.average_complementarity(jv, jd), rtol=1e-13)


def test_max_alpha_of_empty_array_is_inf():
    empty = torch.zeros(0, dtype=torch.float64)
    assert float(tkkt._max_alpha_pos(empty, empty, 0.9)) == float("inf")


def test_quasi_def_solve_routes_blocked_t_through_the_kernel(monkeypatch):
    """Every blocked_t, nwblock == 1 solve goes through the quasi-definite
    apply, single right-hand sides included."""
    calls = []
    orig = kernels.quasi_def_apply
    monkeypatch.setattr(kernels, "quasi_def_apply",
                        lambda *a: calls.append(a[3].shape[0]) or orig(*a))
    _, _, td, tv, _, _ = _build("blocked_t", 1, 1)
    f = tkkt.setup_kkt_factor(tv, td, qn_compact=None)
    r = tkkt.kkt_residual(tv, td, 0.1, 1.0)
    tkkt.solve_kkt(tv, td, f, r)
    assert calls == [1, 1]   # Xa formation (ncon = 1), then the step
