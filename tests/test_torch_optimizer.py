"""The facade and its options: paropt_torch.optimizer and
paropt_torch.utils.options against paropt_tpu's.

- The option registry equals paropt_tpu's and the vendored reference
  table (`tests/reference_options.json`), name for name, with defaults,
  types, ranges and enum values.
- `Optimizer(..., {"algorithm": "mma", "use_fused_loop": True})` is
  `FusedMMA`'s solve; the fused 'ip' route takes the iterations of JAX's
  `fused_ip_optimize` on SyntheticTopology(n=4096), fobj to 1e-10; the
  fused 'tr' route takes JAX's `FusedTR` iterations on the 8x4 FEM
  (tests/test_drivers.py's case), fobj to 1e-10, and, as in JAX, has no
  multipliers for `get_optimized_point`.
- The host routes, the facade's default (``use_fused_loop`` unset), are
  held against paropt_tpu.Optimizer beside each host solver's parity tests
  (tests/test_torch_ip.py, test_torch_tr_host.py, test_torch_mma_host.py),
  where the JAX package's compiled steps are already warm.
"""

import json
import math
import os

import pytest
import torch

from paropt_tpu import ip_fused as jip
from paropt_tpu.models.fem_topology import FEMTopology as JFEM
from paropt_tpu.optimizer import Optimizer as JOptimizer
from paropt_tpu.models.topology import SyntheticTopology as JTopology
from paropt_tpu.utils import options as joptions
from paropt_torch import Optimizer, ip_fused as tip, mma as tmma
from paropt_torch.models.fem_topology import FEMTopology as TFEM
from paropt_torch.models.topology import SyntheticTopology as TTopology
from paropt_torch.utils import options as toptions
from paropt_torch.utils.chunked import make_write_output_hook
torch.set_num_threads(1)

F64 = torch.float64
EXTENSIONS = {"dtype", "qn_storage_dtype", "qn_subspace_auto",
              "mma_kkt_error_scaling", "mma_max_no_improvement",
              "use_fused_loop"}


def _spec(d):
    return (d.name, d.otype, d.default, d.low, d.high, d.values)


@pytest.mark.parametrize("which", ["all", "ip", "tr", "mma", "facade"])
def test_registry_equals_paropt_tpu(which):
    ours = toptions.make_options(which=which)
    ref = joptions.make_options(which=which)
    assert list(ours) == list(ref)
    assert [_spec(d) for d in ours.descriptors()] == \
        [_spec(d) for d in ref.descriptors()]


def test_registry_equals_reference_table():
    path = os.path.join(os.path.dirname(__file__), "reference_options.json")
    with open(path) as f:
        groups = json.load(f)
    ref = {}
    for grp in groups.values():
        ref.update(grp)
    ours = toptions.make_options()
    assert set(ours) - set(ref) == EXTENSIONS
    assert set(ref) <= set(ours)
    for name, spec in ref.items():
        d = ours.descriptor(name)
        assert d.otype == spec["type"], name
        assert ours[name] == spec["default"], name
        if spec["type"] in ("int", "float"):
            assert (float(d.low), float(d.high)) == (spec["low"],
                                                     spec["high"]), name
        if spec["type"] == "enum":
            assert list(d.values) == spec["values"], name
    with pytest.raises(ValueError):
        ours["monotone_barrier_fraction"] = 1.5
    with pytest.raises(KeyError):
        ours["no_such_option"] = 1


def test_mma_route_is_fused_mma():
    opts = {"algorithm": "mma", "use_fused_loop": True,
            "mma_output_file": None, "mma_max_iterations": 6}
    opt = Optimizer(TFEM(8, 4, cg_iters=250, dtype=F64,
                         device="cpu"), dict(opts))
    res = opt.optimize()
    want, st = tmma.FusedMMA(TFEM(8, 4, cg_iters=250, dtype=F64, device="cpu"),
                             dict(opts)).solve()
    assert res["niter"] == want["niter"] == 6
    assert res["fobj"] == want["fobj"]
    assert torch.equal(res["x"], want["x"])
    x, z, zw, zl, zu = opt.get_optimized_point()
    assert torch.equal(x, st.x) and torch.equal(z, st.z)
    assert torch.equal(zl, st.zl) and torch.equal(zu, st.zu)
    assert zw.shape == (0,)


def test_ip_route_matches_jax_fused_ip_optimize():
    """The facade's fused IP solve on SyntheticTopology(n=4096): the
    registry defaults (monotone, in-loop L-BFGS msub 10, f64) give JAX's
    iteration count and fobj to 1e-10."""
    opts = {"algorithm": "ip", "use_fused_loop": True, "output_file": None}
    jres, _ = jip.fused_ip_optimize(JTopology(n=4096, block=8), dict(opts))
    opt = Optimizer(TTopology(n=4096, block=8, dtype=F64,
                              device="cpu"), dict(opts))
    res = opt.optimize()
    assert res["converged"] and jres["converged"]
    assert res["niter"] == jres["niter"]
    assert res["fobj"] == pytest.approx(jres["fobj"], rel=1e-10)
    assert res["res_norm"] < 1e-6
    assert res["ngeval"] == res["niter"] + 1
    x, z, zw, zl, zu = opt.get_optimized_point()
    assert torch.equal(x, res["x"])
    assert z.shape == (1,) and zw.shape == (512,)


def test_fused_ip_optimize_write_output_cadence(tmp_path):
    calls = []

    class Recorded(TTopology):
        def write_output(self, it, x):
            calls.append(it)

    res, _ = tip.fused_ip_optimize(
        Recorded(n=512, block=8, dtype=F64, device="cpu"),
        {"write_output_frequency": 10, "abs_res_tol": 1e-5})
    assert res["converged"]
    assert calls == [1] + list(range(10, res["niter"] + 1, 10))
    # checkpoints are ported: ip_checkpoint_file gets the full state at
    # the same cadence (tests/test_torch_checkpoint.py resumes from it)
    ckpt = str(tmp_path / "ip.pt")
    res, state = tip.fused_ip_optimize(
        TTopology(n=64, block=8, dtype=F64, device="cpu"),
        {"ip_checkpoint_file": ckpt, "write_output_frequency": 10})
    from paropt_torch.utils.checkpoint import restore_state
    assert int(restore_state(ckpt, state).k) == 10 * (res["niter"] // 10)
    hook = make_write_output_hook(None, 10, checkpoint_path=ckpt)
    assert hook is not None
    assert make_write_output_hook(print, 0) is None


def test_tr_route_matches_jax_fused_tr():
    """tests/test_drivers.py's fused TR facade case on FEMTopology(8, 4,
    mgcg): the port's route takes JAX's outer and inner iterations to the
    same fobj, and get_optimized_point raises as JAX's does."""
    opts = {"algorithm": "tr", "use_fused_loop": True, "output_file": None,
            "tr_output_file": None, "tr_max_iterations": 10}
    jopt = JOptimizer(JFEM(nex=8, ney=4, cg_iters=25, solver="mgcg"),
                      dict(opts))
    jres = jopt.optimize()
    opt = Optimizer(TFEM(8, 4, cg_iters=25, solver="mgcg", dtype=F64,
                         device="cpu"),
                    dict(opts))
    res = opt.optimize()
    assert res["fobj"] < 0.9 and res["infeas"] < 1e-6
    assert (res["niter"], res["subiters"]) == (jres["niter"],
                                               jres["subiters"])
    assert res["fobj"] == pytest.approx(jres["fobj"], rel=1e-10)
    with pytest.raises(RuntimeError, match="FusedTR"):
        jopt.get_optimized_point()
    with pytest.raises(RuntimeError, match="FusedTR"):
        opt.get_optimized_point()


def test_registry_option_passes_through():
    """An OptionRegistry reaches the solvers as it is (no copy)."""
    reg = toptions.make_options({"algorithm": "mma", "use_fused_loop": True,
                                 "mma_max_iterations": 2,
                                 "dtype": "float32"}, which="facade")
    opt = Optimizer(TFEM(8, 4, cg_iters=250, dtype=torch.float32,
                         device="cpu"), reg)
    assert opt.options is reg
    res = opt.optimize()
    assert res["niter"] == 2 and res["x"].dtype == torch.float32
    assert math.isfinite(res["fobj"])
