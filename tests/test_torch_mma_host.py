"""The host-loop MMA: paropt_torch.mma.MMA against paropt_tpu.mma.MMA on
SyntheticTopology(256) (the blocked_t sparse constraints, so the inner
solves take the quasi-definite apply's plain version), in float64.

- The true MMA approximation and the linearized constraints for 4 outer
  iterations: the same outer and inner iterations, fobj to 1e-10
  relative, x, the asymptotes and the design history to 1e-8, logs that
  parse alike.
- One outer iteration of each package from the same mid-solve JAX state
  loaded through `convert.load_mma`.
- `Optimizer(problem, {"algorithm": "mma"})` runs the host MMA, held
  against paropt_tpu.Optimizer.
"""

import numpy as np
import pytest
import torch

from paropt_tpu import mma as jmma
from paropt_tpu.models.topology import SyntheticTopology as JTopology
from paropt_torch import convert
from paropt_torch import mma as tmma
from paropt_torch.models.topology import SyntheticTopology as TTopology

from ._torch_parity import (assert_close, assert_facade_matches,
                            assert_logs_alike)

torch.set_num_threads(1)

F64 = torch.float64


def _pair(opts, tmp_path=None):
    if tmp_path is not None:
        jo = dict(opts, mma_output_file=str(tmp_path / "j"))
        to = dict(opts, mma_output_file=str(tmp_path / "t"))
    else:
        jo = to = dict(opts, mma_output_file=None)
    return (jmma.MMA(JTopology(n=256, block=8), jo),
            tmma.MMA(TTopology(n=256, block=8, dtype=F64, device="cpu"), to))


@pytest.mark.parametrize("linearized", [False, True])
def test_mma_matches(linearized, tmp_path):
    """The linearized case also runs the gradient-scaled tolerances and the
    no-improvement window."""
    extra = ({"mma_kkt_error_scaling": "gradient",
              "mma_max_no_improvement": 2} if linearized else {})
    jm, tm = _pair(dict(extra, output_file=None, mma_max_iterations=4,
                        mma_use_constraint_linearization=linearized),
                   tmp_path)
    jr, tr = jm.optimize(), tm.optimize()
    assert (tr["niter"], tr["converged"], tr["stalled"]) == \
        (jr["niter"], jr["converged"], jr["stalled"])
    assert tm.subproblem_iter == jm.subproblem_iter > 0
    assert tr["fobj"] == pytest.approx(jr["fobj"], rel=1e-10)
    for key in ("infeas", "l1", "linfty"):
        assert tr[key] == pytest.approx(jr[key], rel=1e-6, abs=1e-12), key
    for got, want in ((tr["x"], jr["x"]), *zip(tm.get_asymptotes(),
                                               jm.get_asymptotes()),
                      *zip(tm.get_design_history(),
                           jm.get_design_history())):
        assert_close(got, want, rtol=0.0, atol=1e-8)
    assert_logs_alike(tmp_path / "j", tmp_path / "t", "mma")
    assert tm.syncs.count > 0


def test_one_outer_iteration_from_jax_state():
    """Two outer iterations of the JAX solve, then one more of the same JAX
    solver and one of the port's loaded from its state (`convert.load_mma`):
    the iterates, asymptotes and multipliers to 1e-12."""
    opts = {"output_file": None, "mma_max_iterations": 2}
    jm, tm = _pair(opts)
    jm.optimize()
    names = ("x", "x1", "x2", "L", "U", "z", "zw", "zl", "zu")
    state = {k: np.asarray(getattr(jm, k)) for k in names}
    state.update(mma_iter=jm.mma_iter, subproblem_iter=jm.subproblem_iter)
    convert.load_mma(tm, state)
    assert tm.mma_iter == jm.mma_iter
    jm.options["mma_max_iterations"] = tm.options["mma_max_iterations"] = 1
    jm.optimize()
    tm.optimize()
    assert tm.subproblem_iter == jm.subproblem_iter
    for k in names:
        assert_close(getattr(tm, k), getattr(jm, k), rtol=1e-12, atol=1e-13,
                     name=k)


def test_facade_mma_route_matches():
    assert_facade_matches(
        JTopology(n=256, block=8),
        TTopology(n=256, block=8, dtype=F64, device="cpu"),
        {"algorithm": "mma", "mma_max_iterations": 2}, "mma")
