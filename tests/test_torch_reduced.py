"""`paropt_torch.reduced.ReducedProblem` against paropt_tpu.reduced on the
cases of tests/test_reduced.py (the quartic of `examples/reduced_problem/
reduced.py`), in float64 on the CPU: the host IP and the TR facade take
the same iterations, fobj within 1e-10 relative and x within 1e-8; the
reduced gradient, Jacobian and Hessian-vector product equal paropt_tpu's
to 1e-14.  Also the port's own: the scatter keeps the wrapped problem's
dtype and device (paropt_tpu's template is float64 whatever the problem's
dtype; ROADMAP queue 3), autodiff reaches the free subset, and the input
checks."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paropt_torch import InteriorPoint as TIP
from paropt_torch import Problem as TProblem
from paropt_torch import ReducedProblem as TReduced
from paropt_torch.optimizer import Optimizer as TOptimizer
from paropt_tpu import InteriorPoint as JIP
from paropt_tpu import Problem as JProblem
from paropt_tpu import ReducedProblem as JReduced
from paropt_tpu.optimizer import Optimizer as JOptimizer

torch.set_num_threads(1)


class JQuartic(JProblem):
    """min x0^4 + x1^4 + x2^4  s.t.  x0 + x1 + x2 - 1 >= 0."""

    def __init__(self):
        super().__init__(nvars=3, ncon=1)

    def objective(self, x):
        return jnp.sum(x ** 4)

    def constraints(self, x):
        return jnp.array([x[0] + x[1] + x[2] - 1.0])

    def get_vars_and_bounds(self):
        return jnp.ones(3), jnp.zeros(3), jnp.full(3, 10.0)


class TQuartic(TProblem):
    def __init__(self, dtype=torch.float64):
        super().__init__(nvars=3, ncon=1)
        self.kw = dict(dtype=dtype, device="cpu")

    def objective(self, x):
        return torch.sum(x ** 4)

    def constraints(self, x):
        return (x[0] + x[1] + x[2] - 1.0).reshape(1)

    def get_vars_and_bounds(self):
        return (torch.ones(3, **self.kw), torch.zeros(3, **self.kw),
                torch.full((3,), 10.0, **self.kw))


SOLVES = {
    "ip": lambda red, Solver: Solver[0](red, {"output_file": None,
                                             "abs_res_tol": 1e-8}).optimize(),
    "tr_facade": lambda red, Solver: Solver[1](red, {
        "algorithm": "tr", "output_file": None, "tr_output_file": None,
        "tr_max_iterations": 100}).optimize(),
}


@pytest.mark.parametrize("route", sorted(SOLVES))
def test_reduced_solve_matches_jax(route):
    # fix x0 = 0.1: the reduced optimum is x1 = x2 = 0.45
    jred = JReduced(JQuartic(), fixed_idx=[0], fixed_vals=[0.1])
    tred = TReduced(TQuartic(), fixed_idx=[0], fixed_vals=[0.1])
    assert (tred.nvars, tred.ncon) == (jred.nvars, jred.ncon) == (2, 1)
    jr = SOLVES[route](jred, (JIP, JOptimizer))
    tr = SOLVES[route](tred, (TIP, TOptimizer))
    assert tr["niter"] == jr["niter"]
    np.testing.assert_allclose(tr["fobj"], jr["fobj"], rtol=1e-10)
    np.testing.assert_allclose(tr["x"].numpy(), np.asarray(jr["x"]),
                               rtol=0.0, atol=1e-8)
    np.testing.assert_allclose(tr["x"].numpy(), [0.45, 0.45], atol=1e-3)
    np.testing.assert_allclose(tred.expand(tr["x"]).numpy(),
                               np.asarray(jred.expand(jr["x"])), atol=1e-8)
    assert float(tred.expand(tr["x"])[0]) == 0.1


def test_reduced_derivatives_match_jax():
    jred = JReduced(JQuartic(), fixed_idx=[1], fixed_vals=[0.3])
    tred = TReduced(TQuartic(), fixed_idx=[1], fixed_vals=[0.3])
    x = np.array([0.7, 0.2])
    jg, jA = jred.eval_obj_con_gradient(jnp.asarray(x))
    tg, tA = tred.eval_obj_con_gradient(torch.tensor(x))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-14)
    np.testing.assert_allclose(tA.numpy(), np.asarray(jA), rtol=1e-14)
    np.testing.assert_allclose(tg.numpy(), [4 * 0.7 ** 3, 4 * 0.2 ** 3])
    px = np.array([1.0, 0.0])
    jhv = jred.eval_hvec_product(jnp.asarray(x), jnp.zeros(1), None,
                                 jnp.asarray(px))
    thv = tred.eval_hvec_product(torch.tensor(x), torch.zeros(1,
                                 dtype=torch.float64), None,
                                 torch.tensor(px))
    np.testing.assert_allclose(thv.numpy(), np.asarray(jhv), rtol=1e-14)
    np.testing.assert_allclose(thv.numpy(), [12 * 0.7 ** 2, 0.0])
    # autodiff through the scatter reaches only the free subset
    g = torch.func.grad(tred.objective)(torch.tensor(x))
    np.testing.assert_allclose(g.numpy(), tg.numpy(), rtol=1e-15)


def test_reduced_keeps_dtype_and_device():
    """A float32 problem stays float32 through expand / restrict (paropt_
    tpu's template is float64 whatever the problem's dtype)."""
    tred = TReduced(TQuartic(dtype=torch.float32), fixed_idx=[2],
                    fixed_vals=[0.25])
    x0, lb, ub = tred.get_vars_and_bounds()
    assert x0.dtype == torch.float32 and x0.shape == (2,)
    full = tred.expand(torch.tensor([0.5, 0.75], dtype=torch.float32))
    assert full.dtype == torch.float32 and full.device.type == "cpu"
    assert full.tolist() == [0.5, 0.75, 0.25]
    assert tred.restrict(full).tolist() == [0.5, 0.75]
    f, c = tred.eval_obj_con(torch.tensor([0.5, 0.75]))
    assert f.dtype == torch.float32


def test_reduced_validation():
    for idx, vals in (([0, 0], [0.1, 0.2]), ([0], [0.1, 0.2])):
        with pytest.raises(ValueError):
            TReduced(TQuartic(), fixed_idx=idx, fixed_vals=vals)
    from paropt_torch.models.topology import SyntheticTopology
    with pytest.raises(ValueError, match="nwcon"):
        TReduced(SyntheticTopology(n=64, block=8, dtype=torch.float64,
                                   device="cpu"), [0], [1.0])
