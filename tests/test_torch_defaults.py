"""The port runs on the CUDA card unless the caller asks for the CPU: every
model and state constructor given no device resolves it to ``cuda``.

Without a card, making the first tensor there raises PyTorch's own error,
and nothing carries on on the CPU.  Each case records what the constructor
resolved and expects that error here (on a machine with a card the object
is built there instead).

The solvers make every tensor on the device of the problem's x0: one
iteration of each host loop and each fused loop, with the problem on the
CPU, runs under
``torch.set_default_device("meta")``, where a tensor made without
``device=`` lands on the meta device and mixing it with the CPU tensors
raises."""

import dataclasses

import numpy as np
import pytest
import torch

from paropt_torch import Optimizer, convert, dtypes, ip, ip_fused
from paropt_torch.models import (analytic, fem_topology, fem_topology3d,
                                 topology)
from paropt_torch.ops import kkt, qn


def _ip_fields():
    v = kkt.zero_vars(8, 1, 2, device="cpu")
    return {f.name: getattr(v, f.name).numpy()
            for f in dataclasses.fields(v)}


# name -> (module that resolves the device, constructor)
CONSTRUCTORS = {
    "SyntheticTopology": (topology, lambda: topology.SyntheticTopology(n=64)),
    "FEMTopology": (fem_topology, lambda: fem_topology.FEMTopology(4, 2)),
    "DMOFEMTopology": (fem_topology,
                       lambda: fem_topology.DMOFEMTopology(4, 2)),
    "FEMTopology3D": (fem_topology3d,
                      lambda: fem_topology3d.FEMTopology3D(4, 2, 2)),
    "DMOFEMTopology3D": (fem_topology3d,
                         lambda: fem_topology3d.DMOFEMTopology3D(2, 2, 2)),
    "Rosenbrock": (analytic, analytic.Rosenbrock),
    "SparseRosenbrock": (analytic, analytic.SparseRosenbrock),
    "ScalableRosenbrock": (analytic, analytic.ScalableRosenbrock),
    "RandomConvexQP": (analytic, analytic.RandomConvexQP),
    "Sellar": (analytic, analytic.Sellar),
    "SimpleQuadratic": (analytic, analytic.SimpleQuadratic),
    "Maratos": (analytic, analytic.Maratos),
    "RandomQuadratic": (analytic,
                        lambda: analytic.RandomQuadratic(eigs=[1.0, 2.0])),
    "Toy": (analytic, analytic.Toy),
    "qn_init": (qn, lambda: qn.qn_init(2, 8)),
    "zero_vars": (kkt, lambda: kkt.zero_vars(8, 1, 2)),
    "convert.to_tensor": (convert, lambda: convert.to_tensor(np.zeros(3))),
    "convert.ip_vars": (convert, lambda: convert.ip_vars(_ip_fields())),
}


def _build(make):
    """The object and its first tensors (a problem makes its starting point
    and bounds only when asked)."""
    obj = make()
    if hasattr(obj, "get_vars_and_bounds"):
        obj.get_vars_and_bounds()
    return obj


def test_resolve_device():
    assert dtypes.resolve_device(None) == torch.device("cuda")
    assert dtypes.resolve_device("cpu") == torch.device("cpu")
    assert dtypes.resolve_device(torch.device("cuda", 1)) == \
        torch.device("cuda", 1)


@pytest.mark.parametrize("name", sorted(CONSTRUCTORS))
def test_constructor_without_device_aims_at_the_card(name, monkeypatch):
    module, make = CONSTRUCTORS[name]
    asked = []

    def spy(device):
        got = dtypes.resolve_device(device)
        asked.append((device, got))
        return got

    monkeypatch.setattr(module, "resolve_device", spy)
    if torch.cuda.is_available():
        _build(make)
    else:
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            _build(make)
    assert asked and asked[0] == (None, torch.device("cuda"))



@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("algorithm", ["ip", "tr", "mma"])
def test_route_makes_no_tensor_off_the_problem_device(algorithm, fused):
    prob = topology.SyntheticTopology(n=64, block=8, dtype=torch.float64,
                                      device="cpu")
    opts = {"algorithm": algorithm, "use_fused_loop": fused,
            "output_file": None,
            "tr_output_file": None, "mma_output_file": None,
            "max_major_iters": 1, "tr_max_iterations": 1,
            "mma_max_iterations": 1}
    torch.set_default_device("meta")
    try:
        res = Optimizer(prob, opts).optimize()
    finally:
        torch.set_default_device(None)
    assert res["x"].device.type == "cpu"


def _on_meta_default(fn):
    torch.set_default_device("meta")
    try:
        return fn()
    finally:
        torch.set_default_device(None)


NK = {"use_hvec_product": True, "gmres_subspace_size": 4,
      "nk_switch_tol": 1e20, "eisenstat_walker_gamma": 0.05,
      "max_gmres_rtol": 1.0}


def test_nk_iteration_makes_no_tensor_off_the_problem_device():
    """One Newton-Krylov step of the host IP and of FusedIP, on the CPU,
    under a meta default device."""
    prob = topology.SyntheticTopology(n=64, block=8, dtype=torch.float64,
                                      device="cpu")
    solver = ip.InteriorPoint(prob, dict(NK, output_file=None,
                                         max_major_iters=3))
    res = _on_meta_default(solver.optimize)
    assert solver.nhvec > 0 and res["x"].device.type == "cpu"

    fused = ip_fused.FusedIP(ip_fused.model_from_problem(prob), 64, 1,
                             prob.nwcon, 1,
                             ip_fused.FusedIPOptions(
                                 use_quasi_newton_update=True, **NK),
                             dtype=torch.float64)
    data, x0 = ip_fused.data_template_from_problem(prob,
                                                   dtype=torch.float64)
    state = fused.init(x0, data, (), qn.qn_init(4, 64, dtype=torch.float64,
                                                device="cpu"), None)
    state = fused.step(state, data, (), None)
    state = _on_meta_default(lambda: fused.step(state, data, (), None))
    assert int(state.gmres_iters) > 0
    assert state.vars.x.device.type == "cpu"


@pytest.mark.parametrize("make", [
    lambda: fem_topology3d.FEMTopology3D(4, 4, 4, cg_iters=4,
                                         solver="mgcg", device="cpu"),
    lambda: fem_topology3d.DMOFEMTopology3D(2, 2, 2, cg_iters=4,
                                            device="cpu")],
    ids=["FEMTopology3D", "DMOFEMTopology3D"])
def test_3d_constructors_stay_on_the_device_and_turn_tf32_off(make):
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    prob = _on_meta_default(make)
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    x0, _, _ = prob.get_vars_and_bounds()
    assert x0.device.type == "cpu"
    f = _on_meta_default(lambda: prob.objective(x0))
    assert f.device.type == "cpu" and torch.isfinite(f)


def _batched_route(route, device):
    """Two instances, one iteration, of a ``solve_batched`` route on
    SyntheticTopology(64) made on ``device`` (None: the default)."""
    from paropt_torch.mma import FusedMMA
    from paropt_torch.tr import FusedTR
    prob = topology.SyntheticTopology(n=64, block=8, dtype=torch.float64,
                                      device=device)
    x0, _, _ = prob.get_vars_and_bounds()
    x0s = torch.stack([x0, 0.5 * x0])
    if route == "ip":
        fused = ip_fused.FusedIP(ip_fused.model_from_problem(prob), 64, 1,
                                 prob.nwcon, 1,
                                 ip_fused.FusedIPOptions(
                                     use_quasi_newton_update=True),
                                 dtype=torch.float64)
        data, _ = ip_fused.data_template_from_problem(prob,
                                                      dtype=torch.float64)
        qn0 = qn.qn_init(4, 64, dtype=torch.float64, device=x0.device)
        return _on_meta_default(lambda: fused.solve_batched(
            x0s, data, (), qn0, max_iters=1)).vars.x
    opts = {"output_file": None, "tr_output_file": None,
            "mma_output_file": None, "tr_max_iterations": 1,
            "mma_max_iterations": 1, "dtype": "float64"}
    solver = (FusedMMA if route == "mma" else FusedTR)(prob, opts)
    return _on_meta_default(lambda: solver.solve_batched(x0s))[0]["x"]


@pytest.mark.parametrize("route", ["ip", "mma", "tr"])
def test_batched_route_makes_no_tensor_off_the_problem_device(route):
    x = _batched_route(route, "cpu")
    assert x.shape == (2, 64) and x.device.type == "cpu"


@pytest.mark.parametrize("route", ["ip", "mma", "tr"])
def test_batched_route_without_device_aims_at_the_card(route):
    """A batched solve whose problem is given no device runs on the card;
    without one, PyTorch's own error, and no CPU fallback."""
    if torch.cuda.is_available():
        assert _batched_route(route, None).device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            _batched_route(route, None)
