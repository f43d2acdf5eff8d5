"""The 3-D voxel SIMP models: paropt_torch.models.fem_topology3d against
paropt_tpu.models.fem_topology3d on the same numpy inputs, in float64, on
one 8x4x4 multigrid mesh (two levels: 8x4x4 and 4x2x2) and a 6x3x3 DMO
mesh, each built once per file.

Tolerances are relative to the largest entry of the reference
(`assert_rel`).  The element stiffness is the same numpy code, equal to the
last bit; gather and scatter are exact against the index maps; both
layouts of K(E)·u agree with JAX's [ne, 24] form and with its 576-term
grid stencil (called eagerly, no jit) to 1e-13; the restriction is the
adjoint of the prolongation to 1e-14; the multigrid-CG state solve,
objective, adjoint gradient and constraints agree to 1e-10 (measured:
1e-14); FusedMMA's first five outer iterations take JAX's inner
iteration counts with fobj within 1e-9.  The state memo
(`_torch_state_memo`): mgcg and Jacobi in both layouts and DMO, in float32
and float64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paropt_tpu import mma as jmma
from paropt_tpu.models import fem_topology3d as jfem
from paropt_torch import mma as tmma
from paropt_torch.models import fem_topology3d as tfem

from . import _torch_state_memo as state_memo
from ._torch_parity import assert_close, assert_rel, np_of

torch.set_num_threads(1)

F64 = torch.float64
NEX, NEY, NEZ = 8, 4, 4


@pytest.fixture(scope="module")
def pair():
    return (jfem.FEMTopology3D(NEX, NEY, NEZ, cg_iters=25, solver="mgcg"),
            tfem.FEMTopology3D(NEX, NEY, NEZ, cg_iters=25, solver="mgcg",
                               dtype=F64, device="cpu"))


@pytest.fixture(scope="module")
def dmo_pair():
    return (jfem.DMOFEMTopology3D(6, 3, 3, cg_iters=250),
            tfem.DMOFEMTopology3D(6, 3, 3, cg_iters=250, dtype=F64,
                                  device="cpu"))


def _design(n, seed):
    return np.random.default_rng(seed).uniform(0.05, 1.0, n)


def _moduli(jp, x):
    """The SIMP moduli of a design, from the JAX model, as numpy."""
    return np.array(jp.emin + jp._filter(jnp.asarray(x)) ** jp.penal
                    * (jp.e0 - jp.emin))


def test_element_stiffness_and_problem_arrays(pair):
    jp, tp = pair
    ke = tfem.hex_element_stiffness()
    assert np.array_equal(ke, jfem.hex_element_stiffness())
    assert np.array_equal(np_of(tp.KE), ke)
    for name in ("f", "fixed_mask", "edofs"):
        assert_close(getattr(tp, name), getattr(jp, name), rtol=0,
                     name=name)
    assert tp._mg_dims == jp._mg_dims == [(8, 4, 4), (4, 2, 2)]
    for a, b in zip(tp._mg_fixed, jp._mg_fixed):
        assert_close(a, b, rtol=0)
    assert_rel(tp.c_scale, jp.c_scale, rtol=1e-12)


def test_gather_scatter_match_edofs(pair):
    """The corner-slice gather and pad scatter equal u[edofs] indexing and
    the index-add scatter, and JAX's."""
    jp, tp = pair
    rng = np.random.default_rng(3)
    u = torch.as_tensor(rng.standard_normal(tp.ndof))
    assert torch.equal(tp._gather_elem(u), u[tp.edofs])
    assert_close(tp._gather_elem(u), jp._gather_elem(jnp.asarray(u)),
                 rtol=0)
    fe = torch.as_tensor(rng.standard_normal((tp.ne, 24)))
    ref = torch.zeros(tp.ndof, dtype=F64).index_add(
        0, tp.edofs.reshape(-1), fe.reshape(-1))
    got = tp._scatter_elem(fe)
    assert_rel(got, ref, rtol=1e-14)
    assert_rel(got, jp._scatter_elem(jnp.asarray(fe)), rtol=1e-14)


def test_filter_and_constraints(pair):
    jp, tp = pair
    x = _design(tp.nvars, 0)
    assert_close(tp._filter(torch.as_tensor(x)), jp._filter(jnp.asarray(x)),
                 rtol=1e-15)
    assert_close(tp.constraints(torch.as_tensor(x)),
                 jp.constraints(jnp.asarray(x)), rtol=1e-14)


@pytest.mark.parametrize("layout", ["grid", "aos"])
def test_kmul_both_layouts(pair, layout):
    """K(E)·u in each layout on every multigrid level (both Dirichlet
    forms, and a batch of vectors on the coarse level) against JAX's
    [ne, 24] form; on the fine level also against JAX's grid stencil."""
    jp, tp = pair
    rng = np.random.default_rng(5)
    KE = jnp.asarray(jfem.hex_element_stiffness())
    tp.layout = layout
    try:
        for li, (cx, cy, cz) in enumerate(tp._mg_dims):
            Eg = rng.uniform(1e-3, 1.0, (cx, cy, cz))
            ug = rng.standard_normal((3, cx + 1, cy + 1, cz + 1))
            fixed = tp._mg_fixed[li]
            for zero_entry in (False, True):
                got = tp._kmul_g(torch.as_tensor(Eg), torch.as_tensor(ug),
                                 fixed, zero_entry)
                want = jfem._kmul_aos(KE, jnp.asarray(Eg), jnp.asarray(ug),
                                      jp._mg_fixed[li], zero_entry)
                assert_rel(got, want, rtol=1e-13,
                           name=f"level {li} zero_entry {zero_entry}")
                if li == 0:
                    stencil = jfem._kmul_grid(
                        np.asarray(KE), jnp.asarray(Eg), jnp.asarray(ug),
                        jp._mg_fixed[li], zero_entry)
                    assert_rel(got, stencil, rtol=1e-13)
        # a batch of vectors (the coarse matrix's assembly)
        ub = rng.standard_normal((5, 3, cx + 1, cy + 1, cz + 1))
        got = tp._kmul_g(torch.as_tensor(Eg), torch.as_tensor(ub), fixed,
                         True)
        for b in range(5):
            want = jfem._kmul_aos(KE, jnp.asarray(Eg), jnp.asarray(ub[b]),
                                  jp._mg_fixed[-1], True)
            assert_rel(got[b], want, rtol=1e-13)
        ug = rng.standard_normal((3, NEX + 1, NEY + 1, NEZ + 1))
        assert_rel(tp._energy_g(torch.as_tensor(ug)),
                   jfem._energy_aos(KE, jnp.asarray(ug)), rtol=1e-13)
    finally:
        tp.layout = "auto"


def test_layout_auto_cutoff():
    """'auto' takes the grid form at and above the cutoff, per level."""
    p = tfem.FEMTopology3D(4, 2, 2, cg_iters=1, dtype=F64, device="cpu")
    cut = tfem._GRID_MIN_NNZ
    assert p._use_grid(cut) and p._use_grid(cut + 40)
    assert not p._use_grid(cut - 1)
    p.layout = "aos"
    assert not p._use_grid(1000)
    p.layout = "grid"
    assert p._use_grid(1)
    with pytest.raises(ValueError):
        tfem.FEMTopology3D(4, 2, 2, layout="stencil", device="cpu")


def test_restriction_is_the_prolongation_adjoint(pair):
    """<P c, r> = <c, R r> to 1e-14, the prolongation equals JAX's, and the
    restriction equals `jax.linear_transpose` of JAX's prolongation."""
    jp, tp = pair
    rng = np.random.default_rng(7)
    cx, cy, cz = tp._mg_dims[1]
    c = rng.standard_normal((3, cx + 1, cy + 1, cz + 1))
    r = rng.standard_normal((3, 2 * cx + 1, 2 * cy + 1, 2 * cz + 1))
    pc = tp._prolong(torch.as_tensor(c))
    rr = tp._restrict(torch.as_tensor(r))
    lhs = float(torch.sum(pc * torch.as_tensor(r)))
    rhs = float(torch.sum(torch.as_tensor(c) * rr))
    assert abs(lhs - rhs) <= 1e-14 * max(abs(lhs), 1.0)
    jprol = jp._mg_prolong[0]
    assert_close(pc, jprol(jnp.asarray(c)), rtol=0)
    jrestrict = jax.linear_transpose(
        jprol, jax.ShapeDtypeStruct(c.shape, jnp.float64))
    assert_rel(rr, jrestrict(jnp.asarray(r))[0], rtol=1e-15)


def test_mgcg_solve_objective_gradient(pair):
    """The state solve, the objective, its adjoint gradient and the
    dense constraint's Jacobian to 1e-10; the solve meets K u = f."""
    jp, tp = pair
    x = _design(tp.nvars, 1)
    E = _moduli(jp, x)
    ut = tp._solve(torch.as_tensor(E))
    assert_rel(ut, jp._solve(jnp.asarray(E)), rtol=1e-10)
    res = tp._kmul(torch.as_tensor(E), ut) - torch.where(
        tp.fixed_mask > 0, 0.0, tp.f)
    assert float(torch.linalg.norm(res) / torch.linalg.norm(tp.f)) < 1e-8
    xt = torch.as_tensor(x)
    fj, _ = jp.eval_obj_con(jnp.asarray(x))
    ft, _ = tp.eval_obj_con(xt)
    assert float(ft) == pytest.approx(float(fj), rel=1e-10)
    gj, Aj = jp.eval_obj_con_gradient(jnp.asarray(x))
    gt, At = tp.eval_obj_con_gradient(xt)
    assert_rel(gt, gj, rtol=1e-10)
    assert_rel(At, Aj, rtol=1e-14)


def test_region_caps():
    """Region caps route through the 'blocked' sparse path: the caps and
    their Jacobian, by the JAX model's formulas."""
    p = tfem.FEMTopology3D(4, 2, 2, region=4, region_cap=0.6, cg_iters=5,
                           dtype=F64, device="cpu")
    x = torch.as_tensor(_design(p.nvars, 2))
    assert p.nwcon == 4
    want = 0.6 - x.reshape(4, 4).mean(dim=1)
    assert_close(p.sparse_constraints(x), want, rtol=1e-15)
    jac = p.sparse_jacobian(x)
    assert jac.layout == "blocked"
    assert_close(jac.matvec(x), x.reshape(4, 4).mean(dim=1).neg(),
                 rtol=1e-15)


def test_fused_mma_five_outer_iterations(pair):
    """FusedMMA from the same start: each of the first five outer
    iterations takes JAX's inner iterations, with fobj within 1e-9."""
    jp, tp = pair
    opts = {"mma_output_file": None, "mma_max_iterations": 5}
    jm, tm = jmma.FusedMMA(jp, dict(opts)), tmma.FusedMMA(tp, dict(opts))
    js, ts = jm._state0, tm._state0
    for k in range(5):
        js, ts = jm._step_jit(js), tm._step(ts)
        assert int(ts.subiters) == int(js.subiters), k
        assert float(ts.fobj) == pytest.approx(float(js.fobj), rel=1e-9)
    assert_close(ts.x, js.x, rtol=0, atol=1e-9)


def test_dmo_objective_and_gradient(dmo_pair):
    jp, tp = dmo_pair
    assert_rel(tp.c_scale, jp.c_scale, rtol=1e-12)
    x = np.random.default_rng(4).uniform(0.05, 0.4, tp.nvars)
    fj, cj = jp.eval_obj_con(jnp.asarray(x))
    ft, ct = tp.eval_obj_con(torch.as_tensor(x))
    assert float(ft) == pytest.approx(float(fj), rel=1e-10)
    assert_close(ct, cj, rtol=1e-14)
    gj, _ = jp.eval_obj_con_gradient(jnp.asarray(x))
    gt, _ = tp.eval_obj_con_gradient(torch.as_tensor(x))
    assert_rel(gt, gj, rtol=1e-10)
    assert_close(tp.sparse_constraints(torch.as_tensor(x)),
                 jp.sparse_constraints(jnp.asarray(x)), rtol=1e-14)


# -- the state memo: the gradient reuses its evaluation's state ------------

MEMO_MODELS = {
    "mgcg-grid": lambda dt: tfem.FEMTopology3D(
        NEX, NEY, NEZ, cg_iters=10, solver="mgcg", layout="grid", dtype=dt,
        device="cpu"),
    "mgcg-aos": lambda dt: tfem.FEMTopology3D(
        NEX, NEY, NEZ, cg_iters=10, solver="mgcg", layout="aos", dtype=dt,
        device="cpu"),
    "jacobi-grid": lambda dt: tfem.FEMTopology3D(
        NEX, NEY, NEZ, cg_iters=10, layout="grid", dtype=dt, device="cpu"),
    "jacobi-aos": lambda dt: tfem.FEMTopology3D(
        NEX, NEY, NEZ, cg_iters=10, layout="aos", dtype=dt, device="cpu"),
    "dmo": lambda dt: tfem.DMOFEMTopology3D(4, 2, 2, cg_iters=10, dtype=dt,
                                            device="cpu"),
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
