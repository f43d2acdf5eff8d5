"""The port's DTensor plumbing at world size 1, in the pytest process (one
gloo rank with a ``file://`` init, destroyed at the end of the module):
the sharding helpers, the three kernels' DTensor rules against their plain
versions bit for bit, `HostSyncs` on DTensors, the FEM and frequency
models and `FusedEigenTR` on sharded state (their x-strips at one rank,
tests/test_sharding.py:375-464), and the ``torch.distributed.checkpoint``
round trips of the fused states and of the host InteriorPoint (the
counterparts of tests/test_sharding.py:150-251).  The multi-rank runs are
in tests/test_torch_distributed.py.  float64, one thread.
"""

import dataclasses
import os
import pickle

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)

from paropt_torch import ip_fused
from paropt_torch.ip import HostSyncs, InteriorPoint
from paropt_torch.models.fem_frequency import FrequencyTopology
from paropt_torch.models.fem_topology import DMOFEMTopology, FEMTopology
from paropt_torch.models.fem_topology3d import (DMOFEMTopology3D,
                                                FEMTopology3D)
from paropt_torch.models.topology import SyntheticTopology
from paropt_torch.ops import kernels
from paropt_torch.ops import qn as qnmod
from paropt_torch.parallel import sharding as sh
from paropt_torch.parallel.worker import op_inputs, place_ops, run_ops
from paropt_torch.utils.checkpoint import restore_state, save_state

torch.set_num_threads(1)
F64 = torch.float64
N = 512


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    path = tmp_path_factory.mktemp("pg") / "store"
    dist.init_process_group("gloo", init_method=f"file://{path}", rank=0,
                            world_size=1)
    try:
        yield sh.design_mesh("cpu")
    finally:
        dist.destroy_process_group()


def _fused(n=N):
    prob = SyntheticTopology(n=n, block=8, dtype=F64, device="cpu")
    opts = ip_fused.FusedIPOptions(use_quasi_newton_update=True,
                                   abs_res_tol=1e-6, max_major_iters=400)
    fused = ip_fused.FusedIP(ip_fused.model_from_problem(prob), n, 1,
                             prob.nwcon, 1, opts, dtype=F64)
    data, x0 = ip_fused.data_template_from_problem(prob, dtype=F64)
    return fused, data, x0, qnmod.qn_init(10, n, dtype=F64, device="cpu")


def _whole(t):
    return t.full_tensor() if isinstance(t, DTensor) else t


def _maxdiff(a, b):
    out = 0.0
    for x, y in zip(sh._leaves(a), sh._leaves(b)):
        if x.numel():
            x, y = _whole(x), _whole(y)
            out = max(out, float(torch.max(torch.abs(
                x.to(F64) - y.to(F64)))))
    return out


def test_mesh_and_placement_helpers(mesh):
    assert (sh.DESIGN_AXIS, sh.HOST_AXIS) == ("d", "host")
    assert mesh.mesh_dim_names == ("d",) and mesh.size() == 1
    hyb = sh.hybrid_design_mesh(1, 1, device_type="cpu")
    assert hyb.mesh_dim_names == ("host", "d") and hyb.ndim == 2
    with pytest.raises(ValueError, match="does not cover"):
        sh.hybrid_design_mesh(2, 2, device_type="cpu")
    assert sh.design_sharding(mesh) == [Shard(0)]
    assert sh.row_sharding(hyb) == [Shard(1), Shard(1)]
    assert sh.replicated_sharding(mesh) == [Replicate()]
    assert sh.design_sharding(None) is None
    x = torch.arange(16, dtype=F64)
    assert sh.shard_design(x, mesh).placements == (Shard(0),)
    assert sh.shard_design(x.reshape(2, 8), mesh).placements == (Shard(1),)
    assert sh.replicate(x, hyb).placements == (Replicate(), Replicate())
    assert sh.shard_design(x, None) is x
    assert sh.is_sharded(sh.shard_design(x, mesh)) and not sh.is_sharded(x)
    assert sh.mesh_size(sh.shard_design(x, hyb)) == 1
    sh.init_distributed()             # a no-op: the group exists
    assert dist.get_world_size() == 1


def test_shard_tree_follows_the_placement_rule(mesh):
    """A leaf whose last axis is n is sharded on it, every other leaf
    replicated (tests/test_sharding.py:35-47); static fields, None and
    tuples pass through."""
    fused, data, x0, qn0 = _fused()
    st = sh.shard_tree(fused.init(x0, data, (), qn0, None), mesh, N)
    assert st.vars.x.placements == (Shard(0),)
    assert st.A.placements == (Shard(1),)            # [ncon, n]
    assert st.qn.buf.placements == (Shard(1),)       # [2m, n]
    assert st.vars.zw.placements == (Replicate(),)   # [nwcon]
    assert st.qn.count.placements == (Replicate(),)  # int32 scalar
    assert st.qn.qn_type == qn0.qn_type
    d = sh.shard_tree(data, mesh, N)
    assert d.Aw_vals.placements == (Replicate(),)
    assert d.Aw_layout == "blocked_t"
    b0, Z, M = sh.shard_tree(qnmod.qn_compact(qn0), mesh, N)
    assert Z.placements == (Shard(1),) and M.placements == (Replicate(),)
    assert sh.tree_is_sharded(st) and not sh.tree_is_sharded(data)


@pytest.mark.parametrize("out", ["buf", "dots", "yx", "yw", "gx", "gw",
                                 "gram"])
def test_kernel_rules_match_plain_bitwise(mesh, out):
    """Each op on DTensors placed as the main path places them runs its
    local shard through the op (on the CPU, the plain version) and gives
    the plain version's result on the whole operands bit for bit; the
    outputs come back in the main path's placements and no launch is
    counted on the CPU."""
    ops = op_inputs(N, 1, 21, 10, F64)
    kernels.reset_launches()
    got = run_ops(place_ops(ops, mesh), kernels)
    assert all(v == 0 for v in kernels.LAUNCHES.values())
    want = run_ops(ops, kernels)
    assert isinstance(got[out], DTensor)
    assert torch.equal(got[out].full_tensor(), want[out])
    placement = {"buf": Shard(1), "yx": Shard(1), "gx": Shard(1)}
    assert got[out].placements == (placement.get(out, Replicate()),)


def test_host_syncs_read_dtensors_whole(mesh):
    syncs = HostSyncs()
    x = distribute_tensor(torch.arange(8, dtype=F64), mesh, [Shard(0)])
    total = torch.sum(x)
    assert total.placements == (Partial(),)
    assert syncs.value(total) == 28.0
    assert syncs.values(total, torch.max(x)) == [28.0, 7.0]
    assert syncs(total > 27.0)
    np.testing.assert_array_equal(syncs.array(x), np.arange(8.0))
    assert syncs.count == 4
    # the partial sum (twice), the partial max and the sharded array were
    # gathered whole; the comparison came out replicated
    assert syncs.bytes_gathered == 3 * 8 + 8 * 8
    rep = distribute_tensor(torch.ones(3, dtype=F64), mesh, [Replicate()])
    np.testing.assert_array_equal(syncs.array(rep), np.ones(3))
    assert syncs.bytes_gathered == 88            # a replicated read is local


def test_sharded_fused_step_matches_plain(mesh):
    """One rank holds every shard: the sharded step is the plain step."""
    fused, data, x0, qn0 = _fused()
    st = fused.init(x0, data, (), qn0, None)
    ss = sh.shard_tree(st, mesh, N)
    ds = sh.shard_tree(data, mesh, N)
    for _ in range(3):
        st = fused.step(st, data, (), None)
        ss = fused.step(ss, ds, (), None)
    assert _maxdiff(st, ss) == 0.0
    assert ss.vars.x.placements == (Shard(0),)
    assert ss.fobj.placements == (Replicate(),)      # no pending sum kept


def test_hvp_on_dtensor_matches_forward_mode(mesh):
    """Forward mode has no DTensor rules: on sharded x the product is the
    gradient of <∇L, px>; it equals the jvp product."""
    from paropt_torch.models.analytic import RandomConvexQP
    prob = RandomConvexQP(n=64, ncon=2, seed=5, dtype=F64, device="cpu")
    rng = np.random.default_rng(1)
    x, px = (torch.as_tensor(rng.uniform(0.5, 1.5, 64), dtype=F64)
             for _ in range(2))
    z = torch.as_tensor(rng.uniform(size=2), dtype=F64)
    zw = torch.zeros(0, dtype=F64)
    want = prob.eval_hvec_product(x, z, zw, px)
    run = sh.spmd(prob.eval_hvec_product)
    got = run(sh.shard_design(x, mesh), z, zw, sh.shard_design(px, mesh))
    assert isinstance(got, DTensor)
    torch.testing.assert_close(got.full_tensor(), want, rtol=1e-13,
                               atol=1e-13)


def _frequency():
    return FrequencyTopology(8, 4, N=3, cg_iters=25, solver="mgcg",
                             lobpcg_iters=20, dtype=F64, device="cpu")


KW = dict(dtype=F64, device="cpu")
MODELS_14B = {
    "FEMTopology": lambda: FEMTopology(8, 4, cg_iters=10, solver="mgcg",
                                       **KW),
    "DMOFEMTopology": lambda: DMOFEMTopology(6, 3, cg_iters=10, **KW),
    "FEMTopology3D": lambda: FEMTopology3D(4, 2, 2, cg_iters=10, **KW),
    "DMOFEMTopology3D": lambda: DMOFEMTopology3D(4, 2, 2, cg_iters=10,
                                                 **KW),
    "FrequencyTopology": _frequency,
}


def _rel(got, want):
    got = got.full_tensor() if isinstance(got, DTensor) else got
    scale = float(torch.max(torch.abs(want)))
    return float(torch.max(torch.abs(got - want))) / scale


@pytest.mark.parametrize("name", sorted(MODELS_14B))
def test_item_14b_models_on_sharded_state(mesh, name):
    """The FEM and frequency models evaluate on a sharded design vector
    through their x-strips (`parallel.halo`): objective, constraints and
    gradients equal the plain evaluation's within 1e-14 relative, the
    values come back replicated and the gradients in the design
    placements."""
    prob = MODELS_14B[name]()
    rng = np.random.default_rng(7)
    x = torch.as_tensor(rng.uniform(0.3, 0.9, prob.nvars), dtype=F64)
    xs = sh.shard_design(x, mesh)
    f, c = prob.eval_obj_con(x)
    g, A = prob.eval_obj_con_gradient(x)
    fs, cs = prob.eval_obj_con(xs)
    gs, As = prob.eval_obj_con_gradient(xs)
    assert fs.placements == cs.placements == (Replicate(),)
    assert gs.placements == (Shard(0),) and As.placements == (Shard(1),)
    for got, want in ((fs, f), (cs, c), (gs, g), (As, A)):
        assert _rel(got, want) <= 1e-14
    assert _rel(prob.objective(xs), prob.objective(x)) <= 1e-14


def _eig_tr(freq, iters, **extra):
    return freq.build_fused_tr({**extra,
        "tr_output_file": None, "output_file": None,
        "tr_max_iterations": iters, "tr_init_size": 0.05,
        "tr_max_size": 0.2, "tr_min_size": 1e-6, "abs_res_tol": 1e-8,
        "tr_l1_tol": 1e-4, "tr_linfty_tol": 1e-4,
        "tr_adaptive_gamma_update": True, "penalty_gamma": 10.0,
        "dtype": "float64"})


def test_fused_eigen_tr_on_sharded_state(mesh):
    """FusedEigenTR from a sharded state0 (tests/test_sharding.py:443-464):
    the same outer iterations and fobj within 1e-9 of the plain solve;
    x, the gradients and the sensitivities stay in the design placements,
    the warm-start basis replicated."""
    freq = _frequency()
    solver = _eig_tr(freq, 3)
    res, _ = solver.solve()
    st0 = sh.shard_tree(solver._state0, mesh, freq.nvars)
    assert st0.V.placements == (Replicate(),)
    res_s, st = solver.solve(state0=st0)
    assert res_s["niter"] == res["niter"] == 3
    assert abs(res_s["fobj"] - res["fobj"]) < 1e-9
    assert st.xk.placements == st.gk.placements == (Shard(0),)
    assert st.eig.h.placements == st.Ak.placements == (Shard(1),)
    assert st.qn.buf.placements == (Shard(1),)
    assert st.V.placements == (Replicate(),)


def test_fused_eig_tr_state_dcp_roundtrip(mesh, tmp_path):
    """A sharded FusedEigTRState through the solver's checkpoint_path (a
    DCP directory) and back: equal leaves and placements, and the next
    outer iteration from each is the same."""
    freq = _frequency()
    solver = _eig_tr(freq, 1, tr_write_output_frequency=1)
    st0 = sh.shard_tree(solver._state0, mesh, freq.nvars)
    path = str(tmp_path / "eig")
    _, st = solver.solve(state0=st0, checkpoint_path=path)
    assert os.path.isdir(path)
    back = restore_state(path, st0)
    assert _maxdiff(st, back) == 0.0
    assert back.xk.placements == (Shard(0),)
    assert back.eig.h.placements == (Shard(1),)
    assert back.V.placements == (Replicate(),)
    one = solver.solve(state0=st, jit_loop=False)[1]
    two = solver.solve(state0=back, jit_loop=False)[1]
    assert int(one.k) == 2
    assert _maxdiff(one, two) == 0.0


def test_fused_state_dcp_roundtrip(mesh, tmp_path):
    """A sharded fused state through a DCP directory: equal leaves, the
    same placements, and one more step from each is identical
    (tests/test_sharding.py:168-188)."""
    fused, data, x0, qn0 = _fused()
    st = sh.shard_tree(fused.init(x0, data, (), qn0, None), mesh, N)
    ds = sh.shard_tree(data, mesh, N)
    for _ in range(3):
        st = fused.step(st, ds, (), None)
    path = str(tmp_path / "ckpt")
    save_state(path, st)
    assert os.path.isdir(path)
    template = sh.shard_tree(fused.init(x0, data, (), qn0, None), mesh, N)
    back = restore_state(path, template)
    assert _maxdiff(st, back) == 0.0
    assert back.vars.x.placements == st.vars.x.placements
    assert back.qn.buf.placements == st.qn.buf.placements
    assert int(back.k) == int(st.k) == 3
    assert _maxdiff(fused.step(st, ds, (), None),
                    fused.step(back, ds, (), None)) == 0.0
    # a template of another size is refused
    other = dataclasses.replace(template, vars=dataclasses.replace(
        template.vars, x=sh.shard_design(torch.zeros(2 * N, dtype=F64),
                                         mesh)))
    with pytest.raises(ValueError, match="shape"):
        restore_state(path, other)


class _Opens:
    """Pickles as a call of ``open(path, "w")``: loading it makes the
    file."""

    def __init__(self, path):
        self.path = path

    def __reduce__(self):
        return (open, (self.path, "w"))


@pytest.mark.parametrize("part", [".metadata", "paropt_state.pt"])
def test_sharded_checkpoint_runs_no_code_on_load(mesh, tmp_path, part):
    """A checkpoint directory whose DCP metadata or state metadata was
    replaced by a pickle that calls a function is refused before the call
    runs, as ``torch.load(weights_only=True)`` refuses such a file."""
    fused, data, x0, qn0 = _fused()
    st = sh.shard_tree(fused.init(x0, data, (), qn0, None), mesh, N)
    path = tmp_path / "ckpt"
    save_state(str(path), st)
    assert {".metadata", "paropt_state.pt"} <= set(os.listdir(path))
    marker = tmp_path / "ran"
    with open(path / part, "wb") as f:
        if part == ".metadata":
            pickle.dump(_Opens(str(marker)), f)
        else:
            torch.save(_Opens(str(marker)), f)
    with pytest.raises(pickle.UnpicklingError):
        restore_state(str(path), st)
    assert not marker.exists()


def test_host_ip_sharded_checkpoint_roundtrip(mesh, tmp_path):
    """The host InteriorPoint's write/read_solution_file send sharded state
    through a DCP directory and restore its placements; single-device
    state keeps the npz (tests/test_sharding.py:191-251)."""
    prob = SyntheticTopology(n=N, block=8, dtype=F64, device="cpu")
    ip = InteriorPoint(prob, {"output_file": None, "max_major_iters": 3})
    ip.optimize()
    assert not ip._state_is_sharded()
    ip.vars = sh.shard_tree(ip.vars, mesh, N)
    assert ip._state_is_sharded()
    path = str(tmp_path / "ipckpt")
    ip.write_solution_file(path)
    assert os.path.isdir(path)

    ip2 = InteriorPoint(SyntheticTopology(n=N, block=8, dtype=F64,
                                          device="cpu"),
                        {"output_file": None})
    ip2.vars = sh.shard_tree(ip2.vars, mesh, N)
    ip2.read_solution_file(path)
    assert _maxdiff(ip.vars, ip2.vars) == 0.0
    assert ip2.vars.x.placements == ip.vars.x.placements == (Shard(0),)
    assert ip2.mu == pytest.approx(float(ip.mu))

    ip3 = InteriorPoint(SyntheticTopology(n=N, block=8, dtype=F64,
                                          device="cpu"),
                        {"output_file": None, "max_major_iters": 2})
    ip3.optimize()
    npz = str(tmp_path / "ipckpt_plain")
    ip3.write_solution_file(npz)
    assert os.path.exists(npz + ".npz")


@torch.library.custom_op("paropt_test::twice", mutates_args=())
def _twice(x: torch.Tensor) -> torch.Tensor:
    return 2.0 * x


@_twice.register_fake
def _twice_fake(x):
    return torch.empty_like(x)


def test_op_without_a_sharding_rule_runs_on_replicas(mesh):
    """An op DTensor has no rule for (older PyTorch releases lack some
    linalg rules) runs on the ranks' replicated copies inside a sharded
    entry point; on a sharded operand its error stands."""
    x = torch.arange(4, dtype=F64)
    rep = sh.replicate(x, mesh)
    shd = sh.shard_design(x, mesh)
    with pytest.raises(NotImplementedError, match="sharding strategy"):
        _twice(rep)

    @sh.spmd
    def call(t, probe):
        return _twice(t)

    got = call(rep, shd)
    assert isinstance(got, DTensor) and got.placements == (Replicate(),)
    assert torch.equal(got.to_local(), 2.0 * x)
    with pytest.raises(NotImplementedError, match="sharding strategy"):
        call(shd, shd)


def test_constructors_place_on_a_mesh(mesh):
    """``qn_init(mesh=)`` and ``data_template_from_problem(mesh=)`` place
    their trees by `shard_tree`'s rule; a solve from them runs sharded and
    equals the plain solve's first steps."""
    prob = SyntheticTopology(n=N, block=8, dtype=F64, device="cpu")
    d, x0 = ip_fused.data_template_from_problem(prob, dtype=F64, mesh=mesh)
    qn0 = qnmod.qn_init(10, N, dtype=F64, mesh=mesh)
    assert x0.placements == (Shard(0),) and d.lb.placements == (Shard(0),)
    assert d.cw.placements == (Replicate(),)
    assert qn0.buf.placements == (Shard(1),)
    assert qn0.SS.placements == (Replicate(),)
    fused, data, px0, pqn = _fused()
    got = fused.solve(x0, d, (), qn0, None, max_iters=3)
    want = fused.solve(px0, data, (), pqn, None, max_iters=3)
    assert int(got.k) == int(want.k) == 3
    assert _maxdiff(got, want) == 0.0
