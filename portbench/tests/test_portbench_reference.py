"""Each plain reference against the port's own model functions at a small
size in float64: the synthetic problem's objective, gradient and
constraints, the cantilever's compliance and gradient (filter, SIMP,
state solve), and the MMA step against FusedMMA's with its inner solve
converged tight."""

import numpy as np
import pytest
import torch

from portbench.reference import cantilever3d_8m_mma as cant
from portbench.reference import synth_ip_16m as synth
from portbench.reference._plain import rel_gap, round_tf32

F64 = torch.float64


def test_synthetic_evaluations():
    from paropt_torch.models.topology import SyntheticTopology
    n = 1 << 12
    prog = SyntheticTopology(n=n, block=8, seed=3, dtype=F64, device="cpu")
    ref = synth.SyntheticTopology(n, seed=3)
    x = torch.rand(n, dtype=F64, generator=torch.Generator().manual_seed(1))
    f, c = prog.eval_obj_con(x)
    g, _ = prog.eval_obj_con_gradient(x)
    cw = prog.eval_sparse_con(x)
    rf, rg, rc, rcw = ref.evaluate(x)
    assert rel_gap(f, rf) < 1e-14
    assert rel_gap(g, rg) < 1e-13
    assert abs(float(c[0] - rc)) < 1e-15
    assert rel_gap(cw, rcw) < 1e-15


def test_synthetic_kkt_residual_matches_the_program():
    """At a converged float64 solve the reference's residual is the
    program's (the rows it keeps are the program's largest here)."""
    from paropt_torch import ip_fused
    from paropt_torch.models.topology import SyntheticTopology
    from paropt_torch.ops import kkt, qn
    n = 1 << 12
    prob = SyntheticTopology(n=n, block=8, seed=4, dtype=F64, device="cpu")
    fused = ip_fused.FusedIP(ip_fused.model_from_problem(prob), n, 1,
                             prob.nwcon, 1, ip_fused.FusedIPOptions(
                                 use_quasi_newton_update=True), dtype=F64)
    data, x0 = ip_fused.data_template_from_problem(prob, dtype=F64)
    st = fused.solve(x0, data, (), qn.qn_init(10, n, dtype=F64,
                                              device="cpu"), None)
    assert bool(st.converged)
    ref = synth.SyntheticTopology(n, seed=4)
    rf, rg, rc, rcw = ref.evaluate(st.vars.x)
    v = {k: getattr(st.vars, k) for k in ("x", "z", "zl", "zu", "s", "t",
                                          "zs", "zt", "zw", "sw", "tw",
                                          "zsw", "ztw")}
    got = ref.kkt_residual(v, rg, rc, rcw, float(st.mu))
    d = ip_fused._refresh_data(data, st.g, st.A, st.c, st.cw)
    r = kkt.kkt_residual(st.vars, d, st.mu)
    want = max(float(torch.max(torch.abs(getattr(r, k)))) for k in
               ("x", "zl", "zu", "z", "zs", "zt", "zw", "zsw", "ztw"))
    assert got == pytest.approx(want, rel=1e-9, abs=1e-15)


def test_cantilever_evaluations():
    from paropt_torch.models.fem_topology3d import FEMTopology3D
    prog = FEMTopology3D(8, 4, 4, cg_iters=200, solver="mgcg", dtype=F64,
                         device="cpu")
    ref = cant.Cantilever3D(8, 4, 4)
    assert ref.c_scale == pytest.approx(prog.c_scale, rel=1e-10)
    x = 0.1 + 0.6 * torch.rand(prog.nvars, dtype=F64,
                               generator=torch.Generator().manual_seed(2))
    f, c = prog.eval_obj_con(x)
    g, _ = prog.eval_obj_con_gradient(x)
    rf, rg, vol, relres = ref.evaluate(x)
    assert relres < cant.TRUST
    assert float(f) == pytest.approx(rf, rel=1e-10)
    assert rel_gap(g, rg) < 1e-9
    assert float(c[0]) == pytest.approx(vol, abs=1e-15)


def test_element_stiffness_is_symmetric_with_rigid_modes():
    ke = cant.element_stiffness(0.3)
    assert np.allclose(ke, ke.T, atol=1e-14)
    corners = np.array(cant.CORNERS, dtype=float)
    for axis in range(3):               # translations carry no energy
        u = np.zeros((8, 3))
        u[:, axis] = 1.0
        assert np.allclose(ke @ u.reshape(-1), 0.0, atol=1e-13)
    rot = np.cross([0.0, 0.0, 1.0], corners)   # nor does a rotation
    assert np.allclose(ke @ rot.reshape(-1), 0.0, atol=1e-13)


def test_mma_step_matches_fusedmma():
    """With the inner IP converged tight, FusedMMA's iterates are the exact
    MMA steps of the reference, step after step."""
    from paropt_torch.models.fem_topology3d import FEMTopology3D
    from paropt_torch.mma import FusedMMA
    prob = FEMTopology3D(8, 4, 4, cg_iters=60, solver="mgcg", dtype=F64,
                         device="cpu")
    xs = []
    prob.write_output = lambda k, x: xs.append(x.clone())
    opts = {"mma_max_iterations": 6, "mma_output_file": None,
            "write_output_frequency": 1, "dtype": "float64",
            "abs_res_tol": 1e-11, "mma_move_limit": 0.2,
            "mma_init_asymptote_offset": 0.5, "mma_asymptote_contract": 0.7,
            "mma_asymptote_relax": 1.2, "mma_min_asymptote_offset": 0.01,
            "mma_max_asymptote_offset": 10.0,
            "mma_eps_regularization": 1e-5,
            "mma_delta_regularization": 1e-3}
    FusedMMA(prob, opts).solve(chunk=1)
    ref = cant.Cantilever3D(8, 4, 4)
    hist = [torch.full((prob.nvars,), 0.3, dtype=F64)] + xs
    lu = cant.asymptotes(hist, opts)
    for j in range(len(hist) - 1):
        _, g, vol, _ = ref.evaluate(hist[j])
        y = cant.mma_step(hist[j], *lu[j], g, vol, opts)
        step = torch.linalg.norm(y - hist[j])
        assert float(torch.linalg.norm(hist[j + 1] - y) / step) < 1e-5


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                      -(1.0 + 2 ** -12)], dtype=torch.float32)
    want = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0, 1.0 + 2 * 2 ** -10, -1.0])
    assert torch.equal(round_tf32(x), want)
