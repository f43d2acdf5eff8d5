"""The host-loop trust region: paropt_torch.tr.TrustRegion against
paropt_tpu.tr.TrustRegion on the same problems, in float64.

- SL1QP with the adaptive per-constraint penalties (Rosenbrock, 4 outer
  iterations) and with fixed penalties (4); the filter method with
  second-order correction (Maratos, to convergence): the same outer
  iterations, fobj to 1e-10 relative, x to 1e-8, logs that parse alike
  (the actual/predicted reduction blocks of ``output_level`` 1 included).
- One outer iteration of each package from the same mid-solve JAX state
  loaded through `convert.load_trust_region`.

tests/test_torch_tr_routes.py holds the facade's default route on sparse
constraints, the custom-subproblem route and the host loop against
`FusedTR`."""

import numpy as np
import pytest
import torch

from paropt_tpu import tr as jtr
from paropt_tpu.models import analytic as ja
from paropt_tpu.utils import logging as jlog
from paropt_torch import convert
from paropt_torch import tr as ttr
from paropt_torch.models import analytic as ta
from paropt_torch.utils import logging as tlog

from ._torch_parity import (assert_close, assert_same_tr_solve, fields_of,
                            tr_side_by_side)

torch.set_num_threads(1)

F64 = torch.float64


def _rosen():
    return ja.Rosenbrock(), ta.Rosenbrock(dtype=F64, device="cpu")


@pytest.mark.parametrize("case", ["adaptive", "fixed"])
def test_sl1qp_matches(case, tmp_path):
    opts = {"output_file": None, "tr_max_iterations": 4,
            "tr_adaptive_gamma_update": case == "adaptive",
            "output_level": int(case == "adaptive")}
    jr, tr, _, ts = tr_side_by_side(*_rosen(), opts, tmp_path)
    assert_same_tr_solve(jr, tr, tmp_path)
    assert ts.inner_iters > 0 and ts.syncs.count > 0
    if case == "adaptive":
        for mod in (jlog, tlog):
            j = mod.unpack_tr_2nd_output(str(tmp_path / "j"))
            t = mod.unpack_tr_2nd_output(str(tmp_path / "t"))
            assert len(t["ared(f)"]) == tr["niter"]
            for key in j:
                np.testing.assert_allclose(t[key], j[key], rtol=1e-4,
                                           atol=1e-12, err_msg=key)


def test_filter_with_soc_matches(tmp_path):
    """Maratos (N&W 15.4): full steps near x* are rejected by the filter
    unless the second-order correction re-solves the QP."""
    opts = {"output_file": None, "tr_accept_step_strategy": "filter_method",
            "tr_use_soc": True, "tr_max_soc_iterations": 5,
            "tr_init_size": 1.0, "tr_adaptive_gamma_update": False,
            "penalty_gamma": 100.0, "abs_res_tol": 1e-8,
            "tr_max_iterations": 40, "tr_infeas_tol": 1e-6,
            "tr_l1_tol": 1e-5, "tr_linfty_tol": 1e-5}
    jr, tr, js, ts = tr_side_by_side(ja.Maratos(),
                                   ta.Maratos(dtype=F64, device="cpu"), opts,
                                   tmp_path)
    assert tr["converged"]
    assert_same_tr_solve(jr, tr, tmp_path)
    np.testing.assert_allclose(np.asarray(ts.filter), np.asarray(js.filter),
                               rtol=1e-10)


def test_one_outer_iteration_from_jax_state():
    """Two outer iterations of the JAX solve, then one more of the same JAX
    solver and one of the port's loaded from its state
    (`convert.load_trust_region`): xk, the radius, the penalties and the QN
    state to 1e-12."""
    opts = {"output_file": None, "tr_output_file": None,
            "tr_max_iterations": 2}
    jprob, tprob = _rosen()
    js = jtr.TrustRegion(jprob, opts)
    js.optimize()
    state = {"xk": np.asarray(js.subproblem.xk), "tr_size": js.tr_size,
             "penalty_gamma": js.penalty_gamma.copy(), "filter": js.filter,
             "qn": fields_of(js.qn_holder["state"]),
             "iter_count": js.iter_count}
    tn = convert.load_trust_region(
        ttr.TrustRegion(tprob, dict(opts, tr_max_iterations=1)), state)
    assert tn.iter_count == 2
    js.options["tr_max_iterations"] = 1
    js.optimize()
    tn.optimize()
    assert_close(tn.subproblem.xk, js.subproblem.xk, rtol=1e-12, atol=1e-14,
                 name="xk")
    assert tn.tr_size == pytest.approx(js.tr_size, rel=1e-12)
    np.testing.assert_allclose(tn.penalty_gamma, js.penalty_gamma,
                               rtol=1e-12)
    for name in ("buf", "SS", "SY", "b0"):
        assert_close(getattr(tn.qn_holder["state"], name),
                     getattr(js.qn_holder["state"], name), rtol=1e-12,
                     atol=1e-14, name=name)
