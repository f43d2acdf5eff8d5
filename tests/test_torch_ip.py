"""The host-loop interior-point method: paropt_torch.ip against
paropt_tpu.ip on the same problems and the same numpy inputs, in float64.

- Whole solves of both packages' `InteriorPoint` under each barrier strategy
  and both starting points, against both of JAX's iteration heads (the
  fused one and the separate phases that ``step_verification_frequency``
  selects), the
  DQN -> SLP -> LFail ladder (an indefinite Hessian approximation;
  wrong-sign gradients for the line-search failure and QN reset flags),
  evaluation failures during the line search (with the write-output
  cadence), and the MMA-style diagonal
  Hessian: the same iteration count, fobj to 1e-10 relative, x to 1e-8,
  and logs that parse alike (equal integer columns and info flags, float
  columns within their printed precision).

- `Optimizer(problem, {"algorithm": "ip"})` runs the host InteriorPoint,
  held against paropt_tpu.Optimizer.

tests/test_torch_ip_checks.py holds the sparse-constraint solves, the
iteration phases, the derivative checks, the step from a JAX state and the
unported pieces.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paropt_tpu.models import analytic as ja
from paropt_tpu.problem import Problem as JProblem
from paropt_torch.models import analytic as ta
from paropt_torch.problem import Problem as TProblem

from ._torch_parity import (assert_facade_matches, assert_same_ip_solve,
                            ip_side_by_side)

torch.set_num_threads(1)

F64 = torch.float64


def _rosen():
    return ja.Rosenbrock(), ta.Rosenbrock(dtype=F64, device="cpu")


@pytest.mark.parametrize("barrier,start,iters", [
    ("monotone", "affine_step", 60),
    ("mehrotra", "affine_step", 12),
    ("mehrotra_predictor_corrector", "affine_step", 12),
    ("complementarity_fraction", "affine_step", 12),
    ("monotone", "least_squares_multipliers", 12),
])
def test_barrier_and_start_strategies_match(barrier, start, iters, tmp_path):
    """Rosenbrock: the monotone solve to convergence, the other strategies
    for their first 12 iterations.  The port has one iteration head; JAX
    runs two, which must agree: the monotone case runs with step
    verification on, which takes JAX's separate head (and logs the KKT
    step check), while the complementarity-fraction and least-squares
    cases take its fused head (``_step_scale_merit``)."""
    opts = {"barrier_strategy": barrier, "starting_point_strategy": start,
            "abs_res_tol": 1e-7, "max_major_iters": iters}
    converge = iters == 60
    if converge:
        opts["step_verification_frequency"] = 1
    jr, tr, _, ts = ip_side_by_side(*_rosen(), opts, tmp_path)
    assert_same_ip_solve(jr, tr, tmp_path)
    assert tr["converged"] == converge
    assert ts.syncs.count > 0
    if converge:
        assert "KKT step check" in (tmp_path / "t").read_text()


class _JIndefinite:
    """A Hessian approximation with a negative diagonal that reset leaves
    as it is: its KKT steps are not descent directions."""

    def compact(self):
        return (jnp.asarray(-5.0), None, None)

    def reset(self):
        pass


class _TIndefinite(_JIndefinite):
    def compact(self):
        return (torch.tensor(-5.0, dtype=F64), None, None)


class _JWrongSign(ja.Rosenbrock):
    """Every third gradient evaluation returns -g."""

    def __init__(self):
        super().__init__()
        self.ncall = 0

    def eval_obj_con_gradient(self, x):
        g, A = super().eval_obj_con_gradient(x)
        self.ncall += 1
        return (-g if self.ncall % 3 == 0 else g), A


class _TWrongSign(ta.Rosenbrock):
    def __init__(self):
        super().__init__(dtype=F64, device="cpu")
        self.ncall = 0

    def eval_obj_con_gradient(self, x):
        g, A = super().eval_obj_con_gradient(x)
        self.ncall += 1
        return (-g if self.ncall % 3 == 0 else g), A


@pytest.mark.parametrize("case,flags", [
    ("indefinite", ("DQN", "SLP")),
    ("indefinite_slm", ("DQN", "LFail", "resetH")),
    ("wrong_sign", ("dampH",)),
])
def test_recovery_ladder_matches(case, flags, tmp_path):
    """dm0 >= 0 resets the QN and retries with the diagonal Hessian (DQN),
    then without a Hessian (SLP), then gives up the iteration (LFail);
    a line search that fails resets the QN (resetH)."""
    if case == "wrong_sign":
        probs = (_JWrongSign(), _TWrongSign())
        opts = {"qn_update_type": "damped_update", "max_major_iters": 15}
        setup = None
    else:
        probs = (ja.SimpleQuadratic(n=2),
                 ta.SimpleQuadratic(n=2, dtype=F64, device="cpu"))
        opts = {"use_quasi_newton_update": False, "max_major_iters": 6,
                "sequential_linear_method": case == "indefinite_slm"}

        def setup(solver, package):
            solver.set_quasi_newton_holder(
                {"state": _JIndefinite() if package == "jax"
                 else _TIndefinite()})
    jr, tr, _, _ = ip_side_by_side(*probs, opts, tmp_path, setup)
    assert_same_ip_solve(jr, tr, tmp_path)
    text = (tmp_path / "t").read_text()
    assert all(flag in text for flag in flags), text


class _JFragile(JProblem):
    """Rosenbrock whose evaluation fails outside |x| <= 1.8: a NaN objective
    or an exception (tests/test_ip.py:329-412)."""

    def __init__(self, mode):
        super().__init__(nvars=2, ncon=1)
        self.mode = mode
        self.nfail = 0
        self.written = []

    def eval_obj_con(self, x):
        xn = np.asarray(x)
        f = 100.0 * (xn[1] - xn[0] ** 2) ** 2 + (1.0 - xn[0]) ** 2
        if np.max(np.abs(xn)) > 1.8:
            self.nfail += 1
            if self.mode == "raise":
                raise ValueError("physics solver diverged")
            f = np.nan
        return self._wrap(f), self._wrap([xn[0] + xn[1] + 5.0])

    def eval_obj_con_gradient(self, x):
        xn = np.asarray(x)
        g = [-400.0 * xn[0] * (xn[1] - xn[0] ** 2) - 2.0 * (1 - xn[0]),
             200.0 * (xn[1] - xn[0] ** 2)]
        return self._wrap(g), self._wrap([[1.0, 1.0]])

    def get_vars_and_bounds(self):
        return (self._wrap([-1.5, 1.5]), self._wrap([-2.0, -2.0]),
                self._wrap([2.0, 2.0]))

    def write_output(self, it, x):
        self.written.append(it)

    def _wrap(self, a):
        return jnp.asarray(a, jnp.float64)


class _TFragile(_JFragile):
    def _wrap(self, a):
        return torch.as_tensor(a, dtype=F64, device="cpu")


@pytest.mark.parametrize("mode", ["nan", "raise"])
def test_evaluation_failure_recovery_matches(mode, tmp_path):
    jprob, tprob = _JFragile(mode), _TFragile(mode)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        jr, tr, _, _ = ip_side_by_side(jprob, tprob, {"max_major_iters": 20,
                                                    "write_output_frequency":
                                                    6}, tmp_path)
    assert tprob.nfail == jprob.nfail > 0
    assert tprob.written == jprob.written == [0, 6, 12, 18]
    assert_same_ip_solve(jr, tr, tmp_path)


class _JDiag(JProblem):
    """A separable quartic in a box with its Hessian diagonal:
    min Σ (x - t)^4 + x² over [-1, 1]^2."""

    def __init__(self):
        super().__init__(nvars=2, ncon=0)

    def objective(self, x):
        return self._sum((x - self._wrap([0.9, -0.4])) ** 4 + x ** 2)

    def eval_hessian_diag(self, x, z, zw):
        return 12.0 * (x - self._wrap([0.9, -0.4])) ** 2 + 2.0

    def get_vars_and_bounds(self):
        return (self._wrap([0.1, 0.1]), self._wrap([-1.0, -1.0]),
                self._wrap([1.0, 1.0]))

    def _wrap(self, a):
        return jnp.asarray(a, jnp.float64)

    def _sum(self, a):
        return jnp.sum(a)


class _TDiag(TProblem):
    def __init__(self):
        super().__init__(nvars=2, ncon=0)

    objective = _JDiag.objective
    eval_hessian_diag = _JDiag.eval_hessian_diag
    get_vars_and_bounds = _JDiag.get_vars_and_bounds

    def _wrap(self, a):
        return torch.as_tensor(a, dtype=F64, device="cpu")

    def _sum(self, a):
        return torch.sum(a)


def test_diag_hessian_matches(tmp_path):
    """``use_diag_hessian`` without the line search: the MMA subproblem's
    settings."""
    jr, tr, _, _ = ip_side_by_side(
        _JDiag(), _TDiag(), {"use_diag_hessian": True, "qn_type": "none",
                             "use_line_search": False, "abs_res_tol": 1e-8,
                             "max_major_iters": 100}, tmp_path)
    assert tr["converged"]
    assert_same_ip_solve(jr, tr, tmp_path)


def test_facade_ip_route_matches():
    assert_facade_matches(*_rosen(), {"algorithm": "ip",
                                      "max_major_iters": 12}, "ip")
