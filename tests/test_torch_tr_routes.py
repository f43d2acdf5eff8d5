"""The host trust region's routes: paropt_torch against paropt_tpu in
float64, and the port's host loop against its `FusedTR`.

- `Optimizer(problem)` with the registry's defaults runs the host
  TrustRegion on SyntheticTopology(256) (the sparse blocked_t
  constraints, half of them equalities), held against
  paropt_tpu.Optimizer with its log.
- The custom-subproblem route, whose solves run the host `InteriorPoint`
  (Rosenbrock, 2 outer iterations).
- On SyntheticTopology(256) the port's host loop takes its `FusedTR`
  iterates, as paropt_tpu's does
  (tests/test_tr.py::test_fused_tr_matches_host_loop).
"""

import pytest
import torch

from paropt_tpu import tr as jtr
from paropt_tpu.models import analytic as ja
from paropt_tpu.models.topology import SyntheticTopology as JTopology
from paropt_torch import tr as ttr
from paropt_torch.models import analytic as ta
from paropt_torch.models.topology import SyntheticTopology as TTopology

from ._torch_parity import (assert_close, assert_facade_matches,
                            assert_same_tr_solve, tr_side_by_side)

torch.set_num_threads(1)

F64 = torch.float64


def test_facade_default_route_is_host_tr(tmp_path):
    """SyntheticTopology(256), the sparse blocked_t constraints, the last
    16 of them equalities: the registry's defaults run the host
    TrustRegion in both packages, with the same outer iterations, fobj, x
    and logs (the inner solves' sparse problem data and penalties, zero
    on the sparse inequalities only, and the l1 violation over the sparse
    constraints)."""
    jprob = JTopology(n=256, block=8)
    tprob = TTopology(n=256, block=8, dtype=F64, device="cpu")
    jprob.nwinequality = tprob.nwinequality = 16
    jopt, opt = assert_facade_matches(
        jprob, tprob, {"tr_max_iterations": 3, "abs_res_tol": 1e-8}, "tr",
        log_dir=tmp_path)
    assert opt._inner.inner_iters > 0 and opt._inner.syncs.count > 0
    assert opt._inner.subproblem.nwcon == jopt._inner.subproblem.nwcon == 32


def test_host_loop_takes_fused_iterates():
    """SyntheticTopology(256): the host loop and `FusedTR`, both the port's,
    take the same outer and inner iterations to the same point."""
    opts = {"output_file": None, "tr_output_file": None,
            "tr_max_iterations": 3, "abs_res_tol": 1e-8}
    prob = TTopology(n=256, block=8, dtype=F64, device="cpu")
    host = ttr.TrustRegion(prob, dict(opts))
    hr = host.optimize()
    fr, _ = ttr.FusedTR(prob, dict(opts)).solve()
    assert (hr["niter"], host.inner_iters) == (fr["niter"], fr["subiters"])
    assert hr["fobj"] == pytest.approx(fr["fobj"], rel=1e-12)
    assert_close(hr["x"], fr["x"], rtol=0.0, atol=1e-12)
    for key in ("infeas", "l1", "linfty"):
        assert hr[key] == pytest.approx(fr[key], rel=1e-9, abs=1e-14), key


def test_custom_subproblem_route(tmp_path):
    """A subproblem given to the constructor: the QP and steering solves
    run the host InteriorPoint on it."""
    from paropt_tpu.ops import qn as jqn
    from paropt_torch.ops import qn as tqn
    jprob, tprob = ja.Rosenbrock(), ta.Rosenbrock(dtype=F64, device="cpu")
    jsub = jtr.QuadraticSubproblem(jprob, {"state": jqn.qn_init(4, 2)})
    tsub = ttr.QuadraticSubproblem(tprob, {"state": tqn.qn_init(
        4, 2, dtype=F64, device="cpu")})
    opts = {"output_file": None, "tr_max_iterations": 2,
            "max_major_iters": 15}
    jr, tr, js, ts = tr_side_by_side(jprob, tprob, opts, tmp_path, jsub, tsub)
    assert_same_tr_solve(jr, tr, tmp_path)
    assert ts.ip.niter == js.ip.niter > 0
    assert ts._fused_qp is None
