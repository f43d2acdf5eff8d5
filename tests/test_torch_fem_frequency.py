"""The frequency-constrained models (`paropt_torch.models.fem_frequency`)
against paropt_tpu's on the same numpy inputs, in float64: the 2-D
FrequencyTopology(8, 4, N=3, mgcg) and the 3-D FrequencyTopology3D(4, 2, 2,
N=3) (Jacobi CG with 120 iterations: the mesh cannot coarsen, and an
unconverged CG makes the shift-inverted operator inexact, so LOBPCG's
float64 exit test is never met and its 60 iterations amplify roundoff).

- ``lam_target`` (the calibration eigensolve) to 1e-12 relative;
- ``eval_full``'s (f, c, g, A, M, Minv, h) at x0 and at a perturbed x to
  1e-8 relative to each output's largest entry; M to 1e-8 of its scale
  ks_rho/lam_t² (at x0 one mode dominates, eta collapses and M's entries
  are the cancellation eta² − eta of ~1e-16 terms).  The 3-D x0 is
  symmetric under y <-> z (ny = nz), so its two lowest eigenvalues are
  equal and each package's eigh picks its own basis of that eigenspace:
  there h is held through the basis-free quantities, the pair's sum and
  the third row;
- the host path's float64 KS reduction and `update_eigen_model` (M, Minv,
  hvecs) at the perturbed x;
- the port's own checks, as tests/test_fem_frequency*.py make them for
  JAX: the KS gradient against central differences (1e-6), the eigensolve
  against a dense generalized eigensolve (1e-8), the corner-slice mass
  grid against the [ne, 24] scatter, and the float32 ``_minv_floor``
  regime at 8x4x4, where the floor binds and bounds cond(Minv)."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paropt_tpu.eig import CompactEigenApprox as JEigh
from paropt_tpu.models import fem_frequency as jfreq
from paropt_torch.eig import CompactEigenApprox as TEigh
from paropt_torch.models import fem_frequency as tfreq

from ._torch_parity import assert_close, assert_rel

torch.set_num_threads(1)
F64 = torch.float64

CASES = {
    "2d-8x4": (lambda M, **k: M(8, 4, N=3, cg_iters=25, solver="mgcg",
                                lobpcg_iters=50, **k)),
    "3d-4x2x2": (lambda M, **k: M(4, 2, 2, N=3, cg_iters=120,
                                  solver="jacobi", **k)),
}
_PAIRS = {}


def _pair(name):
    """(JAX model, port model), built once per module."""
    if name not in _PAIRS:
        make = CASES[name]
        cls = "FrequencyTopology3D" if name.startswith("3d") else \
            "FrequencyTopology"
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            _PAIRS[name] = (make(getattr(jfreq, cls), dtype=jnp.float64),
                            make(getattr(tfreq, cls), dtype=F64,
                                 device="cpu"))
    return _PAIRS[name]


def _point(p, which):
    if which == "x0":
        return np.ones(p.nvars)
    return np.random.default_rng(3).uniform(0.3, 1.0, p.nvars)


@pytest.mark.parametrize("name", sorted(CASES))
def test_lam_target_matches_jax(name):
    jp, tp = _pair(name)
    np.testing.assert_allclose(tp.lam_target, jp.lam_target, rtol=1e-12)
    # the calibration's block iterations, each exit read counted
    assert len(tp.lobpcg_iters_log) >= 1 and tp.syncs.count >= \
        tp.lobpcg_iters_log[0]


@pytest.mark.parametrize("which", ["x0", "perturbed"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_eval_full_matches_jax(name, which):
    jp, tp = _pair(name)
    x = _point(jp, which)
    jo = jp.eval_full(jnp.asarray(x))
    to = tp.eval_full(torch.tensor(x))
    for nm, got, want in zip(("f", "c", "g", "A", "Minv"),
                             (to[0], to[1], to[2], to[3], to[5]),
                             (jo[0], jo[1], jo[2], jo[3], jo[5])):
        assert_rel(got, want, 1e-8, name=nm)
    scale = jp.ks_rho / jp.lam_target ** 2
    assert_close(to[4], jo[4], rtol=0.0, atol=1e-8 * scale, name="M")
    h, jh = to[6].numpy(), np.asarray(jo[6])
    if name.startswith("3d") and which == "x0":
        lam = tp._eig_fn(torch.tensor(x), to[7])[0].numpy()
        assert abs(lam[1] - lam[0]) <= 1e-10 * lam[0]     # the y<->z pair
        assert_rel(h[0] + h[1], jh[0] + jh[1], 1e-8, name="h pair sum")
        assert_rel(h[2], jh[2], 1e-8, name="h row 2")
    else:
        assert_rel(h, jh, 1e-8, name="h")
    V = to[7]
    assert V.shape == (tp.fem.ndof, tp.N) and torch.isfinite(V).all()


def test_host_path_matches_jax():
    """The cached host evaluation (float64 numpy KS reduction) and the
    eigen-model refresh callback at the perturbed 2-D point."""
    jp, tp = _pair("2d-8x4")
    x = _point(jp, "perturbed")
    jf, jc = jp.eval_obj_con(jnp.asarray(x))
    tf, tc = tp.eval_obj_con(torch.tensor(x))
    assert_close(tf, jf, rtol=1e-12)
    assert_close(tc, jc, rtol=1e-8)
    jg, jA = jp.eval_obj_con_gradient(jnp.asarray(x))
    tg, tA = tp.eval_obj_con_gradient(torch.tensor(x))
    assert_close(tg, jg, rtol=1e-12)
    assert_rel(tA, jA, 1e-8, name="A")
    je, te = JEigh(jp.nvars, jp.N), TEigh(tp.nvars, tp.N, device="cpu")
    jp.update_eigen_model(jnp.asarray(x), je)
    tp.update_eigen_model(torch.tensor(x), te)
    assert_rel(te.M, je.M, 1e-8, name="M")
    assert_rel(te.Minv, je.Minv, 1e-8, name="Minv")
    assert_rel(te.hvecs, je.hvecs, 1e-8, name="hvecs")
    np.testing.assert_allclose(tp.frequencies(torch.tensor(x)),
                               jp.frequencies(jnp.asarray(x)), rtol=1e-10)


def test_ks_gradient_matches_fd():
    """The analytic eigenvalue sensitivities chained through the filter
    against central differences of the KS aggregate (2-D)."""
    _, p = _pair("2d-8x4")
    rng = np.random.default_rng(2)
    x = rng.uniform(0.3, 1.0, p.nvars)
    d = rng.standard_normal(p.nvars)
    d /= np.linalg.norm(d)
    ex = p._eval(torch.tensor(x))["dks"] @ d
    dh = 1e-6
    fd = (p._eval(torch.tensor(x + dh * d))["ks"]
          - p._eval(torch.tensor(x - dh * d))["ks"]) / (2 * dh)
    assert abs(fd - ex) < 1e-6 * max(1.0, abs(fd)), (fd, ex)


def test_eigensolve_matches_dense():
    """The matrix-free shift-inverted LOBPCG against a dense generalized
    eigensolve on the assembled 2-D matrices."""
    _, p = _pair("2d-8x4")
    fem = p.fem
    x = torch.tensor(np.random.default_rng(1).uniform(0.3, 1.0, p.nvars))
    xf = fem._filter(x)
    E = fem._simp(xf)
    K = torch.func.vmap(lambda col: fem._kmul(E, col), in_dims=1,
                        out_dims=1)(torch.eye(fem.ndof, dtype=F64))
    free = fem.fixed_mask.numpy() == 0
    Kf = K.numpy()[np.ix_(free, free)]
    mf = p._mass_diag(xf).numpy()[free]
    A = Kf / np.sqrt(np.outer(mf, mf))
    lam_ref = np.sort(np.linalg.eigvalsh(0.5 * (A + A.T)))[:p.N]
    lam, W, _ = p._eig_fn(x, None)
    np.testing.assert_allclose(lam.numpy(), lam_ref, rtol=1e-8)
    assert torch.isfinite(W).all()


def test_mass_grid_matches_scatter_3d():
    _, p = _pair("3d-4x2x2")
    fem = p.fem
    xf = torch.tensor(np.random.default_rng(3).uniform(0.1, 1.0, p.nvars))
    _, m = p._mass_grids(xf)
    rho = p.rho_min + xf * (1.0 - p.rho_min)
    ref = fem._scatter_elem(torch.broadcast_to((rho / 8.0)[:, None],
                                               (p.nvars, 24)))
    ref = torch.where(fem.fixed_mask > 0, 0.0, ref)
    assert_close(m, ref, rtol=1e-13)


def test_minv_floor_f32_regime():
    """float32 at 8x4x4 (tests/test_fem_frequency3d.py:88 makes the same
    checks on the JAX model): the floor is 1e3·eps (1e-8 in float64), it
    binds (the raw KS curvature is rank-deficient beyond the float32
    condition bound), and the regularized inverse is NSD with cond
    <= 1/floor."""
    p32 = tfreq.FrequencyTopology3D(8, 4, 4, N=4, cg_iters=30,
                                    lobpcg_iters=50, solver="mgcg",
                                    dtype=torch.float32, device="cpu")
    f32_eps = float(np.finfo(np.float32).eps)
    assert p32._minv_floor() == max(1e-8, 1e3 * f32_eps)
    assert _pair("3d-4x2x2")[1]._minv_floor() == 1e-8
    x0, _, _ = p32.get_vars_and_bounds()
    _, _, _, _, M, Minv, h, V = p32.eval_full(x0)
    scale = p32.ks_rho / p32.lam_target ** 2
    floor = p32._minv_floor() * scale
    e_raw = np.linalg.eigvalsh(M.double().numpy())
    assert np.sum(np.abs(e_raw) < floor) >= 1      # the floor binds
    e_inv = np.linalg.eigvalsh(Minv.double().numpy())
    assert np.all(e_inv < 0.0)
    assert np.max(np.abs(e_inv)) <= 1.0 / floor * 1.01
    assert torch.isfinite(Minv).all() and torch.isfinite(h).all()
    assert torch.isfinite(V).all()
