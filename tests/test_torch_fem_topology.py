"""The 2-D SIMP compliance models: paropt_torch.models.fem_topology against
paropt_tpu.models.fem_topology on the same numpy inputs, in float64, on
meshes of 8x4 to 12x8.

Tolerances are relative to the largest entry of the reference
(`assert_rel`): entries that cancel to ~0 carry the roundoff of the terms
that cancelled.  The element operator and the V-cycle are a few sums of a
few terms, so they agree to 1e-13; the prolongation is exact and its
explicit transpose agrees with JAX's `linear_transpose` to 1e-15; the
Jacobi-CG and multigrid-CG solutions to 1e-12; objective and adjoint
gradient to 1e-11 (measured: 1e-14 to 1e-13).  The state memo
(`_torch_state_memo`): FEM (mgcg, Jacobi) and DMO in float32 and float64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paropt_tpu.models.fem_topology import DMOFEMTopology as JDMO
from paropt_tpu.models.fem_topology import FEMTopology as JFEM
from paropt_torch.models import fem_topology as tfem
from paropt_torch.models.fem_topology import DMOFEMTopology as TDMO
from paropt_torch.models.fem_topology import FEMTopology as TFEM

from . import _torch_state_memo as state_memo
from ._torch_parity import assert_close, assert_rel, np_of



torch.set_num_threads(1)

F64 = torch.float64
# (nex, ney, solver, cg_iters): 12x8 coarsens twice (12x8, 6x4, 3x2)
CASES = [(8, 4, "jacobi", 300), (12, 6, "mgcg", 25), (12, 8, "mgcg", 25)]


@pytest.fixture(scope="module", params=CASES,
                ids=lambda c: f"{c[0]}x{c[1]}-{c[2]}")
def pair(request):
    nex, ney, solver, cg = request.param
    return (JFEM(nex, ney, cg_iters=cg, solver=solver),
            TFEM(nex, ney, cg_iters=cg, solver=solver, dtype=F64,
                 device="cpu"))


def _design(n, seed):
    return np.random.default_rng(seed).uniform(0.05, 1.0, n)


def _moduli(jp, x):
    """The SIMP moduli of a design, from the JAX model, as numpy."""
    return np.array(jp.emin + jp._filter(jnp.asarray(x)) ** jp.penal
                      * (jp.e0 - jp.emin))


def test_gather_scatter_match_edofs(pair):
    """The corner-slice gather and pad scatter equal u[edofs] indexing and
    the index-add scatter, and JAX's."""
    jp, tp = pair
    rng = np.random.default_rng(3)
    u = rng.standard_normal(tp.ndof)
    ut = torch.as_tensor(u)
    assert torch.equal(tp._gather_elem(ut), ut[tp.edofs])
    assert np.array_equal(np_of(tp.edofs), np.asarray(jp.edofs))
    assert_close(tp._gather_elem(ut), jp._gather_elem(jnp.asarray(u)),
                 rtol=0)
    fe = rng.standard_normal((tp.nvars, 8))
    ref = torch.zeros(tp.ndof, dtype=F64).index_add(
        0, tp.edofs.reshape(-1), torch.as_tensor(fe).reshape(-1))
    got = tp._scatter_elem(torch.as_tensor(fe))
    assert_rel(got, ref, rtol=1e-13)
    assert_rel(got, jp._scatter_elem(jnp.asarray(fe)), rtol=1e-13)


def test_problem_arrays_equal(pair):
    jp, tp = pair
    for name in ("KE", "f", "fixed_mask", "free"):
        assert_close(getattr(tp, name), getattr(jp, name), rtol=0,
                     name=name)
    assert tp._mg_dims == jp._mg_dims
    for a, b in zip(tp._mg_fixed, jp._mg_fixed):
        assert_close(a, b, rtol=0)
    assert_rel(tp.c_scale, jp.c_scale, rtol=1e-12)


def test_filter(pair):
    jp, tp = pair
    x = _design(tp.nvars, 0)
    assert_close(tp._filter(torch.as_tensor(x)), jp._filter(jnp.asarray(x)),
                 rtol=1e-15)


def test_kmul_and_kmul_level(pair):
    """K(E) u on the fine grid and on every multigrid level, to 1e-13."""
    jp, tp = pair
    rng = np.random.default_rng(5)
    E = _moduli(jp, _design(tp.nvars, 1))
    u = rng.standard_normal(tp.ndof)
    assert_rel(tp._kmul(torch.as_tensor(E), torch.as_tensor(u)),
               jp._kmul(jnp.asarray(E), jnp.asarray(u)), rtol=1e-13)
    for li, (cx, cy) in enumerate(tp._mg_dims):
        El = rng.uniform(1e-3, 1.0, cx * cy)
        ul = rng.standard_normal(2 * (cx + 1) * (cy + 1))
        got = tp._kmul_level(torch.as_tensor(El), torch.as_tensor(ul), cx,
                             cy, tp._mg_fixed[li])
        want = jp._kmul_level(jnp.asarray(El), jnp.asarray(ul), cx, cy,
                              jp._mg_fixed[li])
        assert_rel(got, want, rtol=1e-13, name=f"level {li}")


def test_prolong_and_restrict_against_linear_transpose(pair):
    """The prolongation equals JAX's exactly; the explicit restriction
    equals `jax.linear_transpose` of JAX's prolongation to 1e-15."""
    jp, tp = pair
    rng = np.random.default_rng(7)
    for l, (cx, cy) in enumerate(tp._mg_dims[1:]):
        ndc = 2 * (cx + 1) * (cy + 1)
        ndf = 2 * (2 * cx + 1) * (2 * cy + 1)
        c = rng.standard_normal(ndc)
        r = rng.standard_normal(ndf)
        assert_close(tp._mg_prolong[l](torch.as_tensor(c)),
                     jp._mg_prolong[l](jnp.asarray(c)), rtol=0)
        restrict = jax.linear_transpose(
            jp._mg_prolong[l], jax.ShapeDtypeStruct((ndc,), jnp.float64))
        want, = restrict(jnp.asarray(r))
        assert_close(tp._mg_restrict[l](torch.as_tensor(r)), want,
                     rtol=1e-15, atol=1e-15)
        # and it is the adjoint: <P c, r> == <c, R r>
        ct, rt = torch.as_tensor(c), torch.as_tensor(r)
        lhs = float(tp._mg_prolong[l](ct) @ rt)
        rhs = float(ct @ tp._mg_restrict[l](rt))
        assert lhs == pytest.approx(rhs, rel=1e-14)


@pytest.mark.parametrize("nex,ney", [(8, 4), (12, 6), (12, 8)])
def test_mg_setup_and_vcycle(nex, ney):
    """Per-level moduli and diagonals, the coarse factor and one V-cycle,
    on two-level and three-level hierarchies."""
    jp = JFEM(nex, ney, cg_iters=25, solver="mgcg")
    tp = TFEM(nex, ney, cg_iters=25, solver="mgcg", dtype=F64, device="cpu")
    E = _moduli(jp, _design(tp.nvars, 2))
    jlev, (jc, _) = jp._mg_setup(jnp.asarray(E))
    tlev, tchol = tp._mg_setup(torch.as_tensor(E))
    for (jE, jd, _, _, _), (tE, td, _, _, _) in zip(jlev, tlev):
        assert_rel(tE, jE, rtol=1e-15)
        assert_rel(td, jd, rtol=1e-15)
    jc = np.triu(np.asarray(jc))
    assert_rel(tchol @ tchol.T, jc.T @ jc, rtol=1e-13)
    r = np.random.default_rng(9).standard_normal(tp.ndof)
    assert_rel(tp._mg_vcycle(tlev, tchol, torch.as_tensor(r)),
                 jp._mg_vcycle(jlev, (jnp.asarray(jc), False),
                             jnp.asarray(r)), rtol=1e-13)


def test_state_solve(pair):
    """Jacobi-CG and multigrid-CG solutions of K(E) u = f, to 1e-12."""
    jp, tp = pair
    E = _moduli(jp, _design(tp.nvars, 4))
    assert_rel(tp._solve(torch.as_tensor(E)), jp._solve(jnp.asarray(E)),
               rtol=1e-12)


def test_objective_constraints_and_adjoint_gradient(pair):
    jp, tp = pair
    x = _design(tp.nvars, 6)
    jf, jc = jp.eval_obj_con(jnp.asarray(x))
    tf, tc = tp.eval_obj_con(torch.as_tensor(x))
    assert_rel(tf, jf, rtol=1e-11)
    assert_rel(tc, jc, rtol=1e-13)
    jg, jA = jp.eval_obj_con_gradient(jnp.asarray(x))
    tg, tA = tp.eval_obj_con_gradient(torch.as_tensor(x))
    assert_rel(tg, jg, rtol=1e-11)
    assert_rel(tA, jA, rtol=1e-13)


def test_adjoint_gradient_reuses_the_forward_solve():
    """The gradient costs one state solve (the forward's u is reused, no
    autograd through CG) and matches a central difference."""
    tp = TFEM(8, 4, cg_iters=300, dtype=F64, device="cpu")
    calls = []
    solve = tp._solve
    tp._solve = lambda E: calls.append(1) or solve(E)
    x = torch.as_tensor(_design(tp.nvars, 8))
    g, _ = tp.eval_obj_con_gradient(x)
    assert len(calls) == 1
    d = torch.as_tensor(np.random.default_rng(8).standard_normal(tp.nvars))
    h = 1e-6
    fd = (tp.objective(x + h * d) - tp.objective(x - h * d)) / (2 * h)
    assert float(g @ d) == pytest.approx(float(fd), rel=1e-6)


def test_region_constraints_blocked():
    """Region caps: values, the 'blocked' Jacobian and its products."""
    jp = JFEM(8, 4, region=4, region_cap=0.7, cg_iters=250)
    tp = TFEM(8, 4, region=4, region_cap=0.7, cg_iters=250, dtype=F64,
              device="cpu")
    x = _design(tp.nvars, 10)
    assert (tp.nwcon, tp.nwblock) == (jp.nwcon, jp.nwblock) == (8, 1)
    assert_rel(tp.eval_sparse_con(torch.as_tensor(x)),
               jp.eval_sparse_con(jnp.asarray(x)), rtol=1e-14)
    tj, jj = tp.sparse_jacobian(None), jp.sparse_jacobian(None)
    assert tj.layout == "blocked"
    assert np.array_equal(np_of(tj.cols), np.asarray(jj.cols))
    assert_close(tj.vals, jj.vals, rtol=0)
    zw = np.random.default_rng(11).standard_normal(tp.nwcon)
    assert_rel(tj.matvec(torch.as_tensor(x)), jj.matvec(jnp.asarray(x)),
               rtol=1e-14)
    assert_rel(tj.rmatvec(torch.as_tensor(zw)), jj.rmatvec(jnp.asarray(zw)),
               rtol=1e-15)
    for got, want in zip(tp.get_vars_and_bounds(), jp.get_vars_and_bounds()):
        assert_close(got, want, rtol=0)


def test_dmo_objective_gradient_and_sparse_constraints():
    jp = JDMO(12, 6, cg_iters=120)
    tp = TDMO(12, 6, cg_iters=120, dtype=F64, device="cpu")
    assert_rel(tp.c_scale, jp.c_scale, rtol=1e-12)
    x = np.random.default_rng(12).uniform(0.01, 0.5, tp.nvars)
    jx, tx = jnp.asarray(x), torch.as_tensor(x)
    jf, jc = jp.eval_obj_con(jx)
    tf, tc = tp.eval_obj_con(tx)
    assert_rel(tf, jf, rtol=1e-11)
    assert_rel(tc, jc, rtol=1e-14)
    jg, jA = jp.eval_obj_con_gradient(jx)
    tg, tA = tp.eval_obj_con_gradient(tx)
    assert_rel(tg, jg, rtol=1e-11)
    assert_rel(tA, jA, rtol=1e-14)
    assert_rel(tp.eval_sparse_con(tx), jp.eval_sparse_con(jx), rtol=1e-15)
    assert tp.sparse_jacobian(None).layout == "blocked"
    assert_close(tp.sparse_jacobian(None).vals, jp.sparse_jacobian(None).vals,
                 rtol=0)
    assert np.array_equal(tp.material_field(tx), jp.material_field(jx))


def test_tf32_off_and_mgcg_fallback_warns():
    torch.backends.cuda.matmul.allow_tf32 = True
    with pytest.warns(UserWarning, match="falls back to Jacobi"):
        odd = TFEM(7, 5, cg_iters=400, solver="mgcg", dtype=F64, device="cpu")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    assert len(odd._mg_dims) == 1
    x0, lb, ub = odd.get_vars_and_bounds()
    assert x0.dtype == lb.dtype == F64
    assert np.isfinite(float(odd.objective(x0)))
    with pytest.raises(ValueError):
        TFEM(8, 4, solver="direct", dtype=F64, device="cpu")


def test_interleave_transpose_is_exact():
    """`_interleave_t` is the adjoint of `_interleave` along either axis."""
    rng = np.random.default_rng(13)
    c = torch.as_tensor(rng.standard_normal((4, 3, 2)))
    for axis in (0, 1):
        out = tfem._interleave(c, axis)
        r = torch.as_tensor(rng.standard_normal(out.shape))
        assert float((out * r).sum()) == pytest.approx(
            float((c * tfem._interleave_t(r, axis)).sum()), rel=1e-14)


# -- the state memo: the gradient reuses its evaluation's state ------------

MEMO_MODELS = {
    "fem-mgcg": lambda dt: TFEM(12, 6, cg_iters=10, solver="mgcg", dtype=dt,
                                device="cpu"),
    "fem-jacobi": lambda dt: TFEM(8, 4, cg_iters=10, dtype=dt,
                                  device="cpu"),
    "dmo": lambda dt: TDMO(6, 3, cg_iters=10, dtype=dt, device="cpu"),
}
MEMO_CASES = [(name, dt) for name in MEMO_MODELS
              for dt in (torch.float32, F64)]
MEMO_IDS = [f"{name}-{str(dt)[6:]}" for name, dt in MEMO_CASES]


@pytest.mark.parametrize("name,dt", MEMO_CASES, ids=MEMO_IDS)
def test_state_memo_hit_equals_miss(name, dt):
    state_memo.check_hit_equals_miss(MEMO_MODELS[name](dt))


@pytest.mark.parametrize("name,dt", MEMO_CASES, ids=MEMO_IDS)
def test_state_memo_misses_after_a_change(name, dt):
    state_memo.check_misses(MEMO_MODELS[name](dt))


@pytest.mark.parametrize("name,dt", MEMO_CASES, ids=MEMO_IDS)
def test_state_memo_released(name, dt):
    state_memo.check_released(MEMO_MODELS[name](dt))


@pytest.mark.parametrize("where", ["vmap", "inference_mode"])
def test_state_memo_not_kept(where):
    """An evaluation of a ``torch.func.vmap`` batch keeps no memo (its
    tensors belong to the transform), nor one of an inference tensor
    (which has no version counter); either gradient solves."""
    tp = TFEM(8, 4, cg_iters=10, dtype=F64, device="cpu")
    x = state_memo.design(tp, 5)
    f_want = tp.objective(x)
    g_want, _ = tp.eval_obj_con_gradient(x)
    tp.eval_obj_con(x)
    if where == "vmap":
        f = torch.func.vmap(lambda xx: tp.eval_obj_con(xx)[0])(
            torch.stack([x, 0.9 * x]))[0]
        assert tp._memo is None
        g, _ = torch.func.vmap(tp.eval_obj_con_gradient)(x[None])
        g = g[0]
    else:
        with torch.inference_mode():
            xi = x.clone()
            f, _ = tp.eval_obj_con(xi)
            assert tp._memo is None
            g, _ = tp.eval_obj_con_gradient(xi)
    assert torch.equal(f, f_want) and torch.equal(g, g_want)
