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

from paropt_torch import Optimizer, convert, dtypes
from paropt_torch.models import analytic, fem_topology, topology
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
