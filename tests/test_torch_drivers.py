"""The driver layer (`paropt_torch.drivers`, `paropt_torch.utils.
plot_history`) against paropt_tpu's, on the CPU in float64:

- `FunctionProblem` with supplied and with finite-difference derivatives:
  the same iterations as paropt_tpu's, fobj within 1e-10 relative, x
  within 1e-8;
- the OpenMDAO drivers (`ParOptDriver`, `ParOptSparseDriver`) and the
  pyOptSparse driver, driven through the jax-free stand-ins
  tests/_fake_openmdao.py and tests/_fake_pyoptsparse.py as
  tests/test_drivers.py and tests/test_pyoptsparse_driver.py install them:
  each package's driver on its own copy of the same fake problem, the same
  final x (1e-8) and the same number of model evaluations (so the same
  trajectory);
- the import gating (ImportError without openmdao or pyoptsparse), the
  facade's refusal of ``use_fused_loop`` for callback problems, and
  `plot_history` on the IP, TR and MMA logs the port writes (also as
  ``python -m``)."""

import importlib
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from paropt_torch import InteriorPoint as TIP
from paropt_torch.drivers import FunctionProblem as TFP
from paropt_tpu import InteriorPoint as JIP
from paropt_tpu.drivers import FunctionProblem as JFP

from . import _fake_openmdao as fake_om
from . import _fake_pyoptsparse as fake_pyo

torch.set_num_threads(1)

Q = np.diag([1.0, 2.0, 3.0])
FP_CASES = {
    "gradients": dict(x0=[2.0, 2.0, 2.0], lb=[-5] * 3, ub=[5] * 3,
                      objective=lambda x: 0.5 * x @ Q @ x,
                      gradient=lambda x: Q @ x,
                      constraints=lambda x: np.array([x.sum() - 1.0]),
                      jacobian=lambda x: np.ones((1, 3))),
    "finite_differences": dict(
        x0=[0.0, 0.0], lb=[-2] * 2, ub=[2] * 2,
        objective=lambda x: (x[0] - 1.0) ** 2 + (x[1] + 0.5) ** 2,
        constraints=lambda x: np.array([2.0 - x[0] - x[1]])),
}


@pytest.mark.parametrize("case", sorted(FP_CASES))
def test_function_problem_matches_jax(case):
    opts = {"output_file": None, "abs_res_tol": 1e-8}
    jp, tp = JFP(**FP_CASES[case]), TFP(**FP_CASES[case], device="cpu")
    jr, tr = JIP(jp, opts).optimize(), TIP(tp, opts).optimize()
    assert tr["converged"] and jr["converged"]
    assert (tr["niter"], tp.neval, tp.ngeval) == (jr["niter"], jp.neval,
                                                  jp.ngeval)
    np.testing.assert_allclose(tr["fobj"], jr["fobj"], rtol=1e-10,
                               atol=1e-14)
    np.testing.assert_allclose(tr["x"].numpy(), np.asarray(jr["x"]),
                               rtol=0.0, atol=1e-8)
    # every callback read x through the problem's counter
    assert tp.syncs.count >= tp.neval + tp.ngeval
    if case == "gradients":
        qinv1 = np.linalg.solve(Q, np.ones(3))
        np.testing.assert_allclose(tr["x"].numpy(), qinv1 / qinv1.sum(),
                                   atol=1e-5)


def _install_fake_openmdao(monkeypatch):
    om_api = types.ModuleType("openmdao.api")
    om_api.Driver = fake_om.Driver
    om_pkg = types.ModuleType("openmdao")
    om_pkg.api = om_api
    monkeypatch.setitem(sys.modules, "openmdao", om_pkg)
    monkeypatch.setitem(sys.modules, "openmdao.api", om_api)


def _driver_module(monkeypatch, pkg, name):
    for mod in ("openmdao_driver", "openmdao_sparse_driver",
                "pyoptsparse_driver"):
        monkeypatch.delitem(sys.modules, f"{pkg}.drivers.{mod}",
                            raising=False)
    return importlib.import_module(f"{pkg}.drivers.{name}")


@pytest.mark.parametrize("sparse", [False, True])
def test_openmdao_drivers_match_jax(monkeypatch, sparse):
    """ParOptDriver on the fake quadratic model, and ParOptSparseDriver with
    the per-element constraint on the separable CSR path."""
    _install_fake_openmdao(monkeypatch)
    name = "openmdao_sparse_driver" if sparse else "openmdao_driver"
    cls = "ParOptSparseDriver" if sparse else "ParOptDriver"
    out = {}
    for pkg in ("paropt_tpu", "paropt_torch"):
        om_prob = fake_om.QuadProblem(n=6)
        driver = getattr(_driver_module(monkeypatch, pkg, name), cls)()
        driver.options.update(algorithm="ip", output_file=None,
                              abs_res_tol=1e-8)
        if pkg == "paropt_torch":
            driver.options["device"] = "cpu"
        driver._setup_driver(om_prob)
        if sparse:
            driver.set_sparse_constraints(["local"])
        assert not driver.run()
        out[pkg] = (om_prob.vals["x"].copy(), om_prob.nruns,
                    driver._paropt_problem)
    (jx, jn, _), (tx, tn, adapter) = out["paropt_tpu"], out["paropt_torch"]
    assert tn == jn
    np.testing.assert_allclose(tx, jx, rtol=0.0, atol=1e-8)
    np.testing.assert_allclose(tx, 0.8, atol=1e-3)
    if sparse:
        assert (adapter.nwcon, adapter.ncon) == (6, 1)
        assert adapter.use_csr_path and adapter.csr_rowp[-1] == 36
        assert adapter.syncs is adapter._dense.syncs


def _qp(fake):
    def objfun(xdict):
        x = xdict["xvars"]
        return {"obj": (x[0] - 2.0) ** 2 + (x[1] - 2.0) ** 2,
                "eq": np.array([x[0] + x[1]]),
                "ineq": np.array([x[0]])}, False

    def sens(xdict, funcs):
        x = xdict["xvars"]
        return {"obj": {"xvars": np.array([2 * (x[0] - 2),
                                           2 * (x[1] - 2)])},
                "eq": {"xvars": np.array([[1.0, 1.0]])},
                "ineq": {"xvars": np.array([[1.0, 0.0]])}}, False

    prob = fake.Optimization("qp", objfun)
    prob.addVarGroup("xvars", 2, value=0.0, lower=-5.0, upper=5.0)
    prob.addObj("obj")
    prob.addConGroup("eq", 1, lower=1.0, upper=1.0)       # equality FIRST
    prob.addConGroup("ineq", 1, upper=0.25)
    return prob, sens, [0.25, 0.75]


def _lower_bounded(fake):
    def objfun(xdict):
        x = xdict["xvars"]
        return {"obj": x[0] ** 2 + x[1] ** 2,
                "con": np.array([x[0] + x[1]])}, False

    def sens(xdict, funcs):
        x = xdict["xvars"]
        return {"obj": {"xvars": 2 * x},
                "con": {"xvars": np.array([[1.0, 1.0]])}}, False

    prob = fake.Optimization("lb", objfun)
    prob.addVarGroup("xvars", 2, value=2.0, lower=-5.0, upper=5.0)
    prob.addObj("obj")
    prob.addConGroup("con", 1, lower=1.0)
    return prob, sens, [0.5, 0.5]


def _clipped(fake):
    def objfun(xdict):
        x = xdict["xvars"]
        return {"obj": float((x[0] - 0.5) ** 2),
                "con": np.array([x[0]])}, False

    def sens(xdict, funcs):
        x = xdict["xvars"]
        return {"obj": {"xvars": np.array([2 * (x[0] - 0.5)])},
                "con": {"xvars": np.array([[1.0]])}}, False

    prob = fake.Optimization("clip", objfun)
    prob.addVarGroup("xvars", 1, value=5.0, lower=0.0, upper=2.0)
    prob.addObj("obj")
    prob.addConGroup("con", 1, upper=10.0)
    return prob, sens, [0.5]


def _unconstrained(fake):
    def objfun(xdict):
        return {"obj": float(np.sum((xdict["xvars"] - 1.5) ** 2))}, False

    def sens(xdict, funcs):
        return {"obj": {"xvars": 2 * (xdict["xvars"] - 1.5)}}, False

    prob = fake.Optimization("uncon", objfun)
    prob.addVarGroup("xvars", 3, value=0.0, lower=-5.0, upper=5.0)
    prob.addObj("obj")
    return prob, sens, [1.5, 1.5, 1.5]


def _csr(fake):
    jac = np.array([[1.0, 1.0, 0.0, 0.0], [0.0, 0.0, 1.0, 1.0]])

    def objfun(xdict):
        x = xdict["xvars"]
        return {"obj": float(np.sum((x - 2.0) ** 2)),
                "con": np.array([x[0] + x[1], x[2] + x[3]])}, False

    def sens(xdict, funcs):
        return {"obj": {"xvars": 2 * (xdict["xvars"] - 2.0)},
                "con": {"xvars": jac}}, False

    prob = fake.Optimization("sp", objfun)
    prob.addVarGroup("xvars", 4, value=0.0, lower=-5.0, upper=5.0)
    prob.addObj("obj")
    prob.addConGroup("con", 2, upper=1.0, jac_pattern=jac.tolist())
    return prob, sens, [0.5] * 4


PYO_CASES = {"dense_ordering": (_qp, False), "lower_bounded": (
    _lower_bounded, False), "start_clipping": (_clipped, False),
    "unconstrained": (_unconstrained, False), "sparse_csr": (_csr, True)}


def _counted(prob):
    calls = []
    objfun = prob.objfun

    def wrapped(xdict):
        calls.append(np.array(xdict["xvars"]))
        return objfun(xdict)

    prob.objfun = wrapped
    return calls


@pytest.mark.parametrize("case", sorted(PYO_CASES))
def test_pyoptsparse_driver_matches_jax(monkeypatch, case):
    """tests/test_pyoptsparse_driver.py's cases: the sign flips, the
    ordering, the start clipping, the dummy constraint and the CSR path."""
    make, sparse = PYO_CASES[case]
    fake_pyo.install(monkeypatch)
    out = {}
    for pkg in ("paropt_tpu", "paropt_torch"):
        drv = _driver_module(monkeypatch, pkg, "pyoptsparse_driver")
        extra = {"device": "cpu"} if pkg == "paropt_torch" else {}
        opt = drv.ParOpt(options={"algorithm": "ip", "output_file": None,
                                  "max_major_iters": 200},
                         sparse=sparse, **extra)
        prob, sens, want = make(fake_pyo)
        calls = _counted(prob)
        sol = opt(prob, sens=sens)
        out[pkg] = (np.asarray(sol.xStar["xvars"]), calls,
                    np.asarray(sol.lambdaStar))
    (jx, jc, jl), (tx, tc, tl) = out["paropt_tpu"], out["paropt_torch"]
    assert len(tc) == len(jc)
    np.testing.assert_allclose(tx, jx, rtol=0.0, atol=1e-8)
    np.testing.assert_allclose(tx, want, atol=1e-3)
    np.testing.assert_allclose(tl, jl, rtol=1e-6, atol=1e-8)
    if case == "start_clipping":
        assert abs(tc[0][0] - 1.0) < 1e-12      # 2 - 0.5 * min(2, 2)


def test_pyoptsparse_sparse_rejects_trust_region(monkeypatch):
    fake_pyo.install(monkeypatch)
    drv = _driver_module(monkeypatch, "paropt_torch", "pyoptsparse_driver")
    opt = drv.ParOpt(options={"algorithm": "tr"}, sparse=True, device="cpu")
    prob = fake_pyo.Optimization("x", lambda xd: ({"obj": 0.0}, False))
    prob.addVarGroup("xvars", 1, value=0.0, lower=0.0, upper=1.0)
    prob.addObj("obj")
    with pytest.raises(ValueError, match="[Tt]rust region"):
        opt(prob, sens=lambda xd, f: ({"obj": {"xvars": np.zeros(1)}},
                                      False))


def test_drivers_need_their_packages(monkeypatch):
    """Like paropt_tpu's, each driver imports its framework at module top:
    without it the import raises ImportError."""
    for name, pkg in (("openmdao_driver", "openmdao"),
                      ("openmdao_sparse_driver", "openmdao"),
                      ("pyoptsparse_driver", "pyoptsparse")):
        monkeypatch.setitem(sys.modules, pkg, None)
        with pytest.raises(ImportError):
            _driver_module(monkeypatch, "paropt_torch", name)


def test_use_fused_loop_rejects_callback_problems():
    """Numpy callbacks cannot run under torch.func.vmap: the facade refuses
    use_fused_loop for a compat problem with a clear error."""
    from paropt_torch import compat
    from paropt_torch.optimizer import Optimizer

    class P(compat.Problem):
        def __init__(self):
            super().__init__(nvars=2, ncon=1, device="cpu")

        def getVarsAndBounds(self, x, lb, ub):
            x[:] = 0.5
            lb[:] = -1.0
            ub[:] = 2.0

    opt = Optimizer(P(), {"algorithm": "tr", "use_fused_loop": True,
                          "output_file": None, "tr_output_file": None})
    with pytest.raises(ValueError, match="torch-native"):
        opt.optimize()


def test_plot_history_on_the_port_logs(tmp_path):
    """The IP, TR and MMA logs of the port's host loops parse and plot
    (as paropt_tpu's plot_history does its own), also from the command
    line."""
    pytest.importorskip("matplotlib")
    from paropt_torch.models.analytic import Rosenbrock
    from paropt_torch.optimizer import Optimizer
    from paropt_torch.utils.plot_history import plot_history
    logs = {"ip": str(tmp_path / "paropt.out"),
            "tr": str(tmp_path / "paropt.tr"),
            "mma": str(tmp_path / "paropt.mma")}
    for algo, path in logs.items():
        Optimizer(Rosenbrock(dtype=torch.float64, device="cpu"), {
            "algorithm": algo, "output_file": logs["ip"],
            "tr_output_file": logs["tr"], "mma_output_file": logs["mma"],
            "abs_res_tol": 1e-6, "tr_max_iterations": 15,
            "mma_max_iterations": 10}).optimize()
        png = str(tmp_path / f"{algo}.png")
        fig = plot_history(path, output=png)
        assert len(fig.axes) == 4 and (tmp_path / f"{algo}.png").exists()
    import os
    from pathlib import Path

    import paropt_torch
    root = str(Path(paropt_torch.__file__).resolve().parents[1])
    run = subprocess.run(
        [sys.executable, "-m", "paropt_torch.utils.plot_history", logs["tr"],
         "-o", str(tmp_path / "cli.png")], capture_output=True, text=True,
        cwd=str(tmp_path), env={**os.environ, "PYTHONPATH": root})
    assert run.returncode == 0, run.stderr
    assert (tmp_path / "cli.png").exists()
