"""Real multi-process runs of the port on sharded state: 4 gloo ranks on a
1-D ("d",) mesh and 4 on the 2 x 2 ("host", "d") mesh, each rank the
program `paropt_torch.parallel.worker` (the counterpart of
tests/test_distributed.py, which runs paropt_tpu's jax.distributed
processes).

One launch per mesh runs every case (`--cases`); the tests read each
rank's JSON and rank 0's final vectors and hold them to:

- the port's own unsharded run in this process: FusedIP on
  SyntheticTopology(2048, block 8) in f64 (5 steps, then the solve to
  1e-6): the same k each step, fobj within 1e-12 relative, x within 1e-10;
- paropt_tpu's run of the same problem on a 4-device mesh of its own
  (tests/test_distributed.py:50-92): per step the same k, fobj and mu
  within 1e-10 relative, res within 1e-7;
- the trust region's fused QP: the same k, x and zw within 1e-10;
- the fused Newton-Krylov phase on RandomConvexQP(256, 2, seed 5): it
  converges, NK engages, x within 1e-6 of the unsharded port and of
  paropt_tpu;
- FusedMMA on SyntheticTopology(512) and its resume: fobj within 1e-8;
- the overhead case's split of a sharded solve's host time (its figures
  are read on the card; here, that both of its solves converge alike);
- the host InteriorPoint: the same iterations, fobj within 1e-12
  relative, and its DCP checkpoint directory read back bit for bit;
- every rank reports the same results.

Both launches run together, with the JAX baselines: 100–150 s of wall
time on 8 cores, float64, one thread per rank.
"""

import dataclasses
import json
import os
import threading

import numpy as np
import pytest
import torch

from paropt_torch.ops import kernels
from paropt_torch.parallel.worker import (HOST_IP_N, HOST_IP_OPTS, MMA_N,
                                          MMA_OPTS, QP_N, nk_solver,
                                          op_inputs, run_ops, spawn,
                                          tr_qp_inputs)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 2048
TOL = 1e-6
MSUB = 10
STEPS = 5
F64 = torch.float64
MESHES = ["1d", "hybrid"]
CASES = {"1d": "ops,ip,ckpt,qp,nk,mma,hostip", "hybrid": "ops,ip,overhead"}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{mesh: [rank 0's JSON, ...], (mesh, "dir"): output directory}."""
    out, errors = {}, []
    dirs = {m: tmp_path_factory.mktemp(f"ranks_{m}") for m in MESHES}

    def launch(mesh):
        d = dirs[mesh]
        args = ["--device", "cpu", "--cases", CASES[mesh], "--out", d,
                "--n", N, "--tol", TOL, "--msub", MSUB, "--steps", STEPS]
        if mesh == "hybrid":
            args += ["--hosts", 2]
        try:
            spawn(4, args, timeout=900, cwd=REPO)
        except Exception as exc:   # reported by the test, not the thread
            errors.append(exc)
            return
        out[mesh] = [json.loads((d / f"rank{r}.json").read_text())
                     for r in range(4)]
        out[mesh, "dir"] = d

    threads = [threading.Thread(target=launch, args=(m,)) for m in MESHES]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return out


def _row(st):
    return {"k": int(st.k), "fobj": float(st.fobj),
            "res": float(st.res_norm), "mu": float(st.mu)}


@pytest.fixture(scope="module")
def unsharded():
    """The port's FusedIP run on plain tensors: the trajectory and x."""
    from paropt_torch import ip_fused
    from paropt_torch.models.topology import SyntheticTopology
    from paropt_torch.ops import qn as qnmod
    prob = SyntheticTopology(n=N, block=8, dtype=F64, device="cpu")
    opts = ip_fused.FusedIPOptions(use_quasi_newton_update=True,
                                   abs_res_tol=TOL, max_major_iters=400)
    fused = ip_fused.FusedIP(ip_fused.model_from_problem(prob), N, 1,
                             prob.nwcon, 1, opts, dtype=F64)
    data, x0 = ip_fused.data_template_from_problem(prob, dtype=F64)
    st = fused.init(x0, data, (), qnmod.qn_init(MSUB, N, dtype=F64,
                                                device="cpu"), None)
    traj = []
    for _ in range(STEPS):
        st = fused.step(st, data, (), None)
        traj.append(_row(st))
    st = fused.solve(None, data, (), state0=st,
                     on_chunk=lambda s: traj.append(_row(s)))
    assert bool(st.converged)
    return traj, st.vars.x.numpy()


@pytest.fixture(scope="module")
def jax_mesh_run():
    """paropt_tpu's trajectory of the same solve over a 4-device mesh,
    placed by the JAX tests' rule (tests/test_distributed.py:50-92)."""
    import jax
    import jax.numpy as jnp
    from paropt_tpu import ip_fused
    from paropt_tpu.models.topology import SyntheticTopology
    from paropt_tpu.ops import qn as qnmod
    from paropt_tpu.parallel import sharding as shlib

    prob = SyntheticTopology(n=N, block=8, dtype=jnp.float64)
    opts = ip_fused.FusedIPOptions(use_quasi_newton_update=True,
                                   abs_res_tol=TOL, max_major_iters=400)
    fused = ip_fused.FusedIP(ip_fused.model_from_problem(prob), N, 1,
                             prob.nwcon, 1, opts, dtype=jnp.float64)
    data, x0 = ip_fused.data_template_from_problem(prob, dtype=jnp.float64)
    qn0 = qnmod.qn_init(MSUB, N, dtype=jnp.float64)
    mesh = shlib.design_mesh(devices=jax.devices()[:4])

    def place(leaf):
        leaf = jnp.asarray(leaf)
        if leaf.ndim >= 1 and leaf.shape[-1] == N:
            sh = (shlib.design_sharding(mesh) if leaf.ndim == 1
                  else shlib.row_sharding(mesh))
            return jax.device_put(leaf, sh)
        return jax.device_put(leaf, shlib.replicated_sharding(mesh))

    state = jax.tree_util.tree_map(place, fused.init(x0, data, (), qn0,
                                                     None))
    data = jax.tree_util.tree_map(place, data)
    traj = []
    for _ in range(400):
        state = fused.step(state, data, (), None)
        traj.append({"k": int(state.k), "fobj": float(state.fobj),
                     "res": float(state.res_norm), "mu": float(state.mu)})
        if bool(state.converged):
            break
    return traj


@pytest.mark.parametrize("mesh", MESHES)
def test_fused_ip_matches_unsharded(runs, unsharded, mesh):
    traj, x = unsharded
    r0 = runs[mesh][0]
    got = r0["ip"]["trajectory"]
    assert r0["ip"]["converged"]
    assert [t["k"] for t in got] == [t["k"] for t in traj]
    np.testing.assert_allclose([t["fobj"] for t in got],
                               [t["fobj"] for t in traj], rtol=1e-12)
    xs = np.load(runs[mesh, "dir"] / "ip_x.npy")
    assert np.max(np.abs(xs - x)) < 1e-10
    # the placement rule held to the end: x, A and the ring buffer
    # sharded on their last axis, the nwcon-sized state replicated
    p = r0["ip"]["placements"]
    assert "Shard(dim=0)" in p["x"] and "Shard(dim=1)" in p["A"]
    assert "Shard(dim=1)" in p["qn.buf"] and "Replicate" in p["zw"]
    assert r0["mesh"] == ([4] if mesh == "1d" else [2, 2])


@pytest.mark.parametrize("mesh", MESHES)
def test_fused_ip_matches_paropt_tpu_mesh(runs, jax_mesh_run, mesh):
    got = runs[mesh][0]["ip"]["trajectory"]
    assert len(got) == len(jax_mesh_run)
    for a, b in zip(got, jax_mesh_run):
        assert a["k"] == b["k"]
        np.testing.assert_allclose(a["fobj"], b["fobj"], rtol=1e-10)
        np.testing.assert_allclose(a["mu"], b["mu"], rtol=1e-10)
        np.testing.assert_allclose(a["res"], b["res"], rtol=1e-7)


@pytest.mark.parametrize("mesh", MESHES)
def test_ranks_report_identical_results(runs, mesh):
    """SPMD determinism: every rank read the same scalars and branched
    alike (the counterpart of the reference's root-broadcast discipline)."""
    ranks = runs[mesh]
    assert [r["rank"] for r in ranks] == [0, 1, 2, 3]
    for r in ranks:
        assert r["world_size"] == 4 and r["backend"] == "gloo"
    for case in CASES[mesh].split(","):
        for r in ranks[1:]:
            assert _untimed(r[case]) == _untimed(ranks[0][case]), case


def _untimed(d):
    """A case's results without its clock readings."""
    if not isinstance(d, dict):
        return d
    return {k: _untimed(v) for k, v in d.items() if "seconds" not in k}


@pytest.mark.parametrize("mesh", MESHES)
def test_kernel_rules_on_four_ranks(runs, mesh):
    """Each op's DTensor rule on 4 ranks against its plain version on the
    whole operands: the roll and both quasi-definite solves bit for bit
    (each rank's sums are the plain version's), the dots and the Gram
    matrix (summed across ranks) within 1e-12 relative; a layout the
    ranks cannot split raises ValueError."""
    ops = runs[mesh][0]["ops"]
    want = run_ops(op_inputs(N, 1, 21, 10, F64), kernels)
    for k in ("buf", "yx", "yw", "gx", "gw"):
        assert ops["maxdiff"][k] == 0.0, k
    for k in ("dots", "gram"):
        scale = float(torch.max(torch.abs(want[k])))
        assert ops["maxdiff"][k] <= 1e-12 * scale, k
    assert "Shard(dim=1)" in ops["placements"]["yx"]
    assert "Replicate" in ops["placements"]["gram"]
    assert "cannot split" in ops["split_error"]


def test_overhead_split_runs_both_solves(runs):
    """The overhead case's plain and sharded solves take the same steps,
    and the spmd mode's own time is counted only where it is entered."""
    o = runs["hybrid"][0]["overhead"]
    assert o["plain"]["iters"] == o["sharded"]["iters"] > 0
    assert o["plain"]["mode_calls"] == 0 and o["plain"]["mode_seconds"] == 0
    assert o["sharded"]["mode_calls"] > 0
    assert 0 < o["sharded"]["mode_seconds"] < o["sharded"]["seconds"]


def test_dcp_checkpoint_on_four_ranks(runs):
    c = runs["1d"][0]["ckpt"]
    assert c["maxdiff"] == 0.0 and c["placements_kept"]
    assert c["step_maxdiff"] == 0.0


def test_tr_fused_qp_sharded(runs):
    tr, p0, data, params = tr_qp_inputs(QP_N, F64, "cpu")
    ref = tr._fused_qp.solve(p0, data, params,
                             compact=(params.b0, params.Z, params.M))
    got = runs["1d"][0]["qp"]
    d = runs["1d", "dir"]
    assert got["converged"] and got["k"] == int(ref.k)
    assert np.max(np.abs(np.load(d / "qp_x.npy") - ref.vars.x.numpy())) \
        < 1e-10
    assert np.max(np.abs(np.load(d / "qp_zw.npy") - ref.vars.zw.numpy())) \
        < 1e-10


def test_fused_nk_sharded(runs):
    import jax.numpy as jnp
    from paropt_tpu import ip_fused as jip
    from paropt_tpu.models.analytic import RandomConvexQP as JQP
    from paropt_tpu.ops import qn as jqn

    fused, data, x0, qn0 = nk_solver(F64, "cpu")
    ref = fused.solve(x0, data, (), qn0, None)
    got = runs["1d"][0]["nk"]
    assert got["converged"] and bool(ref.converged)
    assert max(got["gmres_iters"]) > 0          # NK engaged
    xs = np.load(runs["1d", "dir"] / "nk_x.npy")
    assert np.max(np.abs(xs - ref.vars.x.numpy())) < 1e-6

    jp = JQP(n=256, ncon=2, seed=5)
    jf = jip.FusedIP(jip.model_from_problem(jp), 256, 2, 0, 1,
                     jip.FusedIPOptions(**fused.opts._asdict()),
                     dtype=jnp.float64)
    jd, jx0 = jip.data_template_from_problem(jp, dtype=jnp.float64)
    js = jf.solve(jx0, jd, (), jqn.qn_init(8, 256, dtype=jnp.float64),
                  None)
    assert bool(js.converged)
    assert np.max(np.abs(xs - np.asarray(js.vars.x))) < 1e-6


def test_fused_mma_sharded_and_resume(runs):
    from paropt_torch.mma import FusedMMA
    from paropt_torch.models.topology import SyntheticTopology
    solver = FusedMMA(SyntheticTopology(n=MMA_N, block=8, dtype=F64,
                                        device="cpu"), dict(MMA_OPTS))
    res, st = solver.solve()
    res2, _ = solver.solve(state0=dataclasses.replace(
        st, k=torch.zeros_like(st.k)))
    got = runs["1d"][0]["mma"]
    assert got["niter"] == res["niter"]
    assert abs(got["fobj"] - res["fobj"]) < 1e-8
    assert abs(got["fobj_resumed"] - res2["fobj"]) < 1e-8
    assert got["fobj_resumed"] <= got["fobj"] + 1e-8


def test_host_ip_sharded(runs):
    from paropt_torch.ip import InteriorPoint
    from paropt_torch.models.topology import SyntheticTopology
    res = InteriorPoint(SyntheticTopology(n=HOST_IP_N, block=8, dtype=F64,
                                          device="cpu"),
                        dict(HOST_IP_OPTS)).optimize()
    got = runs["1d"][0]["hostip"]
    assert got["converged"] and res["converged"]
    assert got["niter"] == res["niter"]
    np.testing.assert_allclose(got["fobj"], res["fobj"], rtol=1e-12)
    xs = np.load(runs["1d", "dir"] / "hostip_x.npy")
    assert np.max(np.abs(xs - res["x"].numpy())) < 1e-10
    # the sharded state's checkpoint is a DCP directory, read back whole
    assert got["is_dir"] and got["ckpt_maxdiff"] == 0.0
    assert got["ckpt_placements_kept"] and got["ckpt_mu"]
