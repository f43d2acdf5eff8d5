"""The FEM and eigenvalue models on sharded state across real processes:
4 gloo ranks of `paropt_torch.parallel.worker` on the 1-D ("d",) mesh
(cases fem2d, fem3d, eigtr) and 4 on the 2 x 2 ("host", "d") mesh (fem2d,
its first HYBRID_ITERS outer iterations),
each rank holding its x-strip of the mesh (`paropt_torch.parallel.halo`).
Each case solves on plain tensors and then on sharded state in the same
process; the tests hold:

- FusedMMA on FEMTopology(16, 8, cg_iters=25, mgcg), 8 outer iterations:
  against the unsharded port, the same k per iteration, fobj rtol 1e-9,
  infeas atol 1e-9, l1 rtol 1e-6 (tests/test_distributed.py:224-230);
  against paropt_tpu's run over a 4-device mesh (placed as in
  tests/test_distributed.py:159-183), the same iterations and the final
  fobj within 1e-9;
- FusedMMA on FEMTopology3D(8, 4, 4, cg_iters=20, mgcg), 5 iterations:
  the same against the unsharded port and against paropt_tpu's
  single-device run;
- FusedEigenTR on FrequencyTopology(8, 4, N=3) with
  tests/test_sharding.py:449-464's options: the same outer iterations and
  fobj within 1e-9 of the unsharded port and of paropt_tpu;
- every rank reports the same results;
- locality: a fine-level CG vector holds (nex/P + 1) node rows, no
  exchange of a fine-level CG iteration sends more than one node row to a
  peer, and no gather moves a fine-level nodal vector;
- a mesh whose ranks do not divide nex is refused with a message naming
  the condition.

The launches run one after the other, beside the JAX baselines: ~110 s
of wall time on 8 cores (gloo's exchanges on one host take ~0.5 ms each
at 4 ranks, and the eigen TR's sharded run makes ~14,000 of them per
rank), float64, one thread per rank.
"""

import json
import os
import threading

import numpy as np
import pytest
import torch

from paropt_torch.parallel.worker import (EIG_OPTS, EIGTR, FEM2D, FEM3D,
                                          spawn)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# each launch: its mesh (--hosts) and cases; the 2 x 2 mesh runs the 2-D
# FEM's first HYBRID_ITERS outer iterations
HYBRID_ITERS = 4
LAUNCHES = {"1d": (0, "fem2d,fem3d,eigtr"),
            "hybrid": (2, "fem2d", "--fem2d",
                       ",".join(map(str, FEM2D[:3] + (HYBRID_ITERS,))))}
P = 4


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{launch: [each rank's JSON], "jax": the JAX baselines}: the
    launches run one after the other (a waiting gloo rank keeps its core
    busy, so two launches at once slow each other down), while the JAX
    baselines compute."""
    out, errors = {}, []

    def launch_all():
        for name, (hosts, cases, *extra) in LAUNCHES.items():
            d = tmp_path_factory.mktemp(f"fem_ranks_{name}")
            args = ["--device", "cpu", "--cases", cases, "--out", d, *extra]
            if hosts:
                args += ["--hosts", hosts]
            try:
                spawn(P, args, timeout=900, cwd=REPO)
            except Exception as exc:   # reported by the tests
                errors.append(exc)
                return
            out[name] = [json.loads((d / f"rank{r}.json").read_text())
                         for r in range(P)]

    thread = threading.Thread(target=launch_all)
    thread.start()
    jax = _jax_baselines()
    thread.join()
    if errors:
        raise errors[0]
    out["jax"] = jax
    return out


def _jax_baselines():
    """paropt_tpu's runs: the 2-D FEM over a 4-device mesh, the 3-D FEM on
    one device (trajectories), the eigen TR (niter, fobj)."""
    import jax
    import jax.numpy as jnp
    from paropt_tpu.mma import FusedMMA
    from paropt_tpu.models.fem_frequency import FrequencyTopology
    from paropt_tpu.models.fem_topology import FEMTopology
    from paropt_tpu.models.fem_topology3d import FEMTopology3D
    from paropt_tpu.parallel import sharding as shlib

    def trajectory(prob, iters, mesh):
        solver = FusedMMA(prob, {"mma_max_iterations": iters,
                                 "mma_output_file": None,
                                 "dtype": "float64"})
        state = solver._state0
        if mesh is not None:
            n = prob.nvars

            def place(leaf):
                leaf = jnp.asarray(leaf)
                if leaf.ndim >= 1 and leaf.shape[-1] == n:
                    sh = (shlib.design_sharding(mesh) if leaf.ndim == 1
                          else shlib.row_sharding(mesh))
                    return jax.device_put(leaf, sh)
                return jax.device_put(leaf, shlib.replicated_sharding(mesh))

            state = jax.tree_util.tree_map(place, state)
        rows = []
        for _ in range(iters):
            state = solver._step_jit(state)
            rows.append({"k": int(state.k), "fobj": float(state.fobj),
                         "infeas": float(state.infeas),
                         "l1": float(state.l1)})
            if bool(state.converged):
                break
        return rows

    nex, ney, cg, iters = FEM2D
    fem2d = trajectory(FEMTopology(nex=nex, ney=ney, cg_iters=cg,
                                   solver="mgcg"), iters,
                       shlib.design_mesh(devices=jax.devices()[:P]))
    nex, ney, nez, cg, iters = FEM3D
    fem3d = trajectory(FEMTopology3D(nex=nex, ney=ney, nez=nez,
                                     cg_iters=cg, solver="mgcg"), iters,
                       None)
    nex, ney, N, cg, lob, iters = EIGTR
    freq = FrequencyTopology(nex=nex, ney=ney, N=N, cg_iters=cg,
                             solver="mgcg", lobpcg_iters=lob,
                             dtype=jnp.float64)
    res, _ = freq.build_fused_tr(dict(EIG_OPTS,
                                      tr_max_iterations=iters)).solve()
    return {"fem2d": fem2d, "fem3d": fem3d,
            "eigtr": {"niter": int(res["niter"]),
                      "fobj": float(res["fobj"])}}


def _assert_trajectories_agree(got, want):
    assert [r["k"] for r in got] == [r["k"] for r in want]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a["fobj"], b["fobj"], rtol=1e-9)
        np.testing.assert_allclose(a["infeas"], b["infeas"], atol=1e-9)
        np.testing.assert_allclose(a["l1"], b["l1"], rtol=1e-6)


@pytest.mark.parametrize("case,mesh", [("fem2d", "1d"), ("fem2d", "hybrid"),
                                       ("fem3d", "1d")])
def test_fem_mma_matches_unsharded(runs, case, mesh):
    r0 = runs[mesh][0][case]
    assert r0["plain"]["iterations"] == r0["sharded"]["iterations"] > 1
    _assert_trajectories_agree(r0["sharded"]["trajectory"],
                               r0["plain"]["trajectory"])
    assert r0["max_dx"] < 1e-9
    assert runs[mesh][0]["mesh"] == ([4] if mesh == "1d" else [2, 2])


@pytest.mark.parametrize("case,mesh", [("fem2d", "1d"), ("fem2d", "hybrid"),
                                       ("fem3d", "1d")])
def test_fem_mma_matches_paropt_tpu(runs, case, mesh):
    """paropt_tpu's 2-D run is over a 4-device mesh of its own, its 3-D run
    on one device (tests/test_sharding.py:397-417 holds that one to JAX's
    sharded run within 1e-9)."""
    got = runs[mesh][0][case]["sharded"]["trajectory"]
    want = runs["jax"][case][:len(got)]
    assert len(got) == (HYBRID_ITERS if mesh == "hybrid"
                        else len(runs["jax"][case]))
    _assert_trajectories_agree(got, want)
    assert abs(got[-1]["fobj"] - want[-1]["fobj"]) < 1e-9


def test_eigen_tr_matches_unsharded_and_paropt_tpu(runs):
    """The same outer iterations and fobj within 1e-9 of the unsharded
    port and of paropt_tpu.  The LOBPCG block counts are reported; they
    need not agree where the exit test sits on a roundoff edge (ROADMAP
    queue 3)."""
    e = runs["1d"][0]["eigtr"]
    plain, shd = e["plain"], e["sharded"]
    jax = runs["jax"]["eigtr"]
    assert shd["iterations"] == plain["iterations"] == jax["niter"]
    assert abs(shd["trajectory"][-1]["fobj"]
               - plain["trajectory"][-1]["fobj"]) < 1e-9
    assert abs(shd["trajectory"][-1]["fobj"] - jax["fobj"]) < 1e-9
    assert abs(shd["ks"] - plain["ks"]) < 1e-9
    assert len(shd["lobpcg"]) == len(plain["lobpcg"]) > 0
    print(f"LOBPCG block iterations per eigensolve: plain {plain['lobpcg']}"
          f", sharded {shd['lobpcg']}")


@pytest.mark.parametrize("name", sorted(LAUNCHES))
def test_ranks_report_identical_results(runs, name):
    """SPMD determinism: every rank read the same scalars and ended alike
    (the locality figures are each rank's own)."""
    ranks = runs[name]
    assert [r["rank"] for r in ranks] == list(range(P))
    for r in ranks:
        assert r["world_size"] == P and r["backend"] == "gloo"
    for case in LAUNCHES[name][1].split(","):
        for r in ranks[1:]:
            assert _untimed(r[case]) == _untimed(ranks[0][case]), case


def _untimed(d):
    """A case's results without its clock readings."""
    if not isinstance(d, dict):
        return d
    return {k: _untimed(v) for k, v in d.items()
            if "seconds" not in k and k != "local"}


@pytest.mark.parametrize("case", ["fem2d", "fem3d"])
def test_fine_level_cg_is_local(runs, case):
    """Each rank's fine-level CG vectors are its strip plus one ghost node
    row; one fine-level CG iteration exchanges at most one node row with
    each peer per call (the halo adds, the scalar all-reduces and the
    V-cycle's gather of a coarse level), and no gather moves a fine-level
    nodal vector."""
    nex = (FEM2D if case == "fem2d" else FEM3D)[0]
    r = runs["1d"][0][case]["local"]
    row = r["node_row_entries"]
    assert r["fine_cg_entries"] == (nex // P + 1) * row
    it = r["per_cg_iteration"]
    assert it["max_elements_per_peer"] <= row
    assert it["kinds"]["halo_add"] >= 1 and it["kinds"]["allreduce"] == 2
    assert r["largest_gather"] < r["fine_cg_entries"]
    assert r["gather_point"] >= 1


def test_uneven_strips_are_refused(runs):
    """nex = 18 on 4 ranks: the evaluation raises, naming the condition."""
    msg = runs["1d"][0]["fem2d"]["uneven_error"]
    assert msg is not None and "divide nex = 18" in msg
