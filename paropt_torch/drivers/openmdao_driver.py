"""OpenMDAO driver (counterpart of paropt_tpu/drivers/openmdao_driver.py;
the role of `paropt/paropt_driver.py`).

`ParOptDriver` subclasses `openmdao.api.Driver`, declares every framework
option from the typed registry (as the reference does,
`paropt_driver.py:51-92`) plus ``device`` (where the solver's tensors
live; None: the card), wraps the OpenMDAO problem as a `Problem` whose
evaluations run the model on the host, and runs the selected algorithm.

Requires `openmdao`; importing this module without it raises ImportError.
"""

from __future__ import annotations

import numpy as np
import openmdao.api as om

from ..optimizer import Optimizer as _FrameworkOptimizer
from ..problem import Problem
from ..utils.options import make_options
from .callbacks import HostIO

__all__ = ["ParOptDriver"]


def _sign(meta) -> float:
    """+1 for a lower-bounded inequality (c = val - lower >= 0), -1 for an
    equality (equals - val) or an upper-bounded one (upper - val)."""
    if meta["equals"] is not None:
        return -1.0
    lower = np.atleast_1d(meta["lower"]).ravel()
    if np.all(np.isfinite(lower)) and np.any(lower > -1e20):
        return 1.0
    return -1.0


def _shift(meta, val):
    """The framework's c >= 0 form of a constraint's value."""
    if meta["equals"] is not None:
        return np.atleast_1d(meta["equals"]).ravel() - val
    lower = np.atleast_1d(meta["lower"]).ravel()
    if np.all(np.isfinite(lower)) and np.any(lower > -1e20):
        return val - lower
    return np.atleast_1d(meta["upper"]).ravel() - val


def _user_options(driver) -> dict:
    """The registry options the user changed from their defaults."""
    registry = make_options()
    return {name: driver.options[name] for name in registry
            if name in driver.options and driver.options[name] is not None
            and driver.options[name] != registry[name]}


class _OpenMDAOProblem(HostIO, Problem):
    """An OpenMDAO problem presented as a framework Problem
    (`paropt_driver.py`'s wrapping)."""

    def __init__(self, om_prob, driver, device=None):
        self.om_prob = om_prob
        self.driver = driver
        self._host_io(device)
        dv_meta = driver._designvars
        self._dv_names = list(dv_meta)
        self._sizes = [int(np.prod(dv_meta[name]["size"]))
                       for name in self._dv_names]
        con_meta = driver._cons
        # inequalities first (the framework's convention)
        ineq = [n for n in con_meta if con_meta[n]["equals"] is None]
        eq = [n for n in con_meta if con_meta[n]["equals"] is not None]
        self._con_names = ineq + eq
        super().__init__(
            nvars=sum(self._sizes),
            ncon=sum(int(con_meta[n]["size"]) for n in self._con_names),
            ninequality=sum(int(con_meta[n]["size"]) for n in ineq))

    def _gather_dv(self):
        vals, lbs, ubs = [], [], []
        meta = self.driver._designvars
        dvs = self.driver.get_design_var_values()
        for name in self._dv_names:
            vals.append(np.atleast_1d(dvs[name]).ravel())
            ones = np.ones(vals[-1].shape)
            lbs.append(np.atleast_1d(meta[name]["lower"]).ravel() * ones)
            ubs.append(np.atleast_1d(meta[name]["upper"]).ravel() * ones)
        return (np.concatenate(vals), np.concatenate(lbs),
                np.concatenate(ubs))

    def _scatter_dv(self, x):
        off = 0
        for name, sz in zip(self._dv_names, self._sizes):
            self.driver.set_design_var(name, x[off:off + sz])
            off += sz

    def _run_at(self, x) -> None:
        self._scatter_dv(self._read(x))
        self.om_prob.run_model()

    def get_vars_and_bounds(self):
        return tuple(self._put(a) for a in self._gather_dv())

    def _constraint_values(self):
        meta = self.driver._cons
        cons = self.driver.get_constraint_values()
        rows = [_shift(meta[name], np.atleast_1d(cons[name]).ravel())
                for name in self._con_names]
        return np.concatenate(rows) if rows else np.zeros(0)

    def eval_obj_con(self, x):
        self._run_at(x)
        obj = list(self.driver.get_objective_values().values())[0]
        return (self._put(float(np.atleast_1d(obj)[0])),
                self._put(self._constraint_values()))

    def eval_obj_con_gradient(self, x):
        self._run_at(x)
        obj_name = list(self.driver.get_objective_values())[0]
        totals = self.om_prob.compute_totals(
            of=[obj_name] + self._con_names, wrt=self._dv_names,
            return_format="array")
        meta = self.driver._cons
        rows, off = [], 1
        for name in self._con_names:
            sz = int(meta[name]["size"])
            rows.append(_sign(meta[name]) * totals[off:off + sz])
            off += sz
        Amat = np.vstack(rows) if rows else np.zeros((0, self.nvars))
        return self._put(totals[0]), self._put(Amat)


class ParOptDriver(om.Driver):
    """OpenMDAO driver running this framework's optimizers."""

    def _declare_options(self):
        for desc in make_options().descriptors():
            kwargs = {"default": desc.default}
            if desc.otype == "enum":
                kwargs["values"] = list(desc.values)
            if desc.doc:
                kwargs["desc"] = desc.doc
            try:
                self.options.declare(desc.name, **kwargs)
            except Exception:   # an option the Driver base declares
                pass
        self.options.declare("device", default=None,
                             desc="device of the solver's tensors "
                                  "(None: the CUDA card)")

    def _setup_driver(self, problem):
        super()._setup_driver(problem)
        self.supports["inequality_constraints"] = True
        self.supports["equality_constraints"] = True
        self.supports["two_sided_constraints"] = False

    def _adapter(self):
        return _OpenMDAOProblem(self._problem(), self,
                                device=self.options["device"])

    def run(self):
        prob = self._adapter()
        self._paropt_problem = prob
        opt = _FrameworkOptimizer(prob, _user_options(self))
        result = opt.optimize()
        x = opt.get_optimized_point()[0]
        prob._scatter_dv(prob.syncs.array(x))
        self._problem().run_model()
        return not result.get("converged", False)
