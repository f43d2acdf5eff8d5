"""pyOptSparse driver (counterpart of paropt_tpu/drivers/
pyoptsparse_driver.py; the role of `paropt/paropt_pyoptsparse.py`).

Registers a `ParOpt` optimizer class with pyOptSparse.  The adapters turn
pyOptSparse's constraint convention into the framework's c(x) >= 0 form by
negating constraint values and Jacobians (`paropt_pyoptsparse.py:74-86`)
and apply the reference's starting-point clipping (move strictly inside
the bounds by half the average bound gap, `:48-72`).  Each evaluation runs
pyOptSparse's ``_masterFunc`` on the host (`callbacks.HostIO`).

Requires `pyoptsparse`; importing this module without it raises ImportError.
"""

from __future__ import annotations

import datetime

import numpy as np
from pyoptsparse.pyOpt_optimizer import Optimizer as _PyOptOptimizer
from pyoptsparse.pyOpt_utils import INFINITY

from ..optimizer import Optimizer as _FrameworkOptimizer
from ..problem import CSRSparseProblem, Problem
from ..utils.options import make_options
from .callbacks import HostIO

__all__ = ["ParOpt"]


def _clip_start(xs, blx, bux):
    """The starting-point clipping heuristic (`paropt_pyoptsparse.py:
    48-72`)."""
    n = len(xs)
    bound_sum = 0.0
    for i in range(n):
        if blx[i] <= -INFINITY or bux[i] >= INFINITY:
            bound_sum += 1.0
        else:
            bound_sum += bux[i] - blx[i]
    bound_sum /= n
    x = np.array(xs, dtype=float)
    for i in range(n):
        if xs[i] <= blx[i]:
            x[i] = blx[i] + 0.5 * min(bound_sum, bux[i] - blx[i])
        elif xs[i] >= bux[i]:
            x[i] = bux[i] - 0.5 * min(bound_sum, bux[i] - blx[i])
    return x


class _Start:
    """The clipped start and the bounds, shared by both adapters."""

    def get_vars_and_bounds(self):
        return (self._put(_clip_start(self.xs, self.blx, self.bux)),
                self._put(self.blx), self._put(self.bux))


class _DenseAdapter(_Start, HostIO, Problem):
    """pyOptSparse's _masterFunc as a dense-constraint Problem
    (`ParOptDenseProblem`, `paropt_pyoptsparse.py:92-160`)."""

    def __init__(self, ptr, nvars, ncon, ninequality, xs, blx, bux,
                 device=None):
        super().__init__(nvars=nvars, ncon=ncon, ninequality=ninequality)
        self._host_io(device)
        self.ptr = ptr
        self.xs, self.blx, self.bux = xs, blx, bux

    def eval_obj_con(self, x):
        fobj, fcon, fail = self.ptr._masterFunc(self._read(x),
                                                ["fobj", "fcon"])
        if fail:
            return self._put(np.nan), self._put(np.full(self.ncon, np.nan))
        return self._put(float(fobj)), self._put(-np.atleast_1d(fcon))

    def eval_obj_con_gradient(self, x):
        gobj, gcon, fail = self.ptr._masterFunc(self._read(x),
                                                ["gobj", "gcon"])
        return (self._put(np.asarray(gobj).reshape(self.nvars)),
                self._put(-np.asarray(gcon).reshape(self.ncon, self.nvars)))


class _SparseAdapter(_Start, HostIO, CSRSparseProblem):
    """The CSR sparse-constraint adapter (`ParOptSparseProblem`,
    `paropt_pyoptsparse.py:17-90`): every pyOptSparse constraint becomes a
    sparse constraint with the CSR pattern of the problem's Jacobian."""

    def __init__(self, ptr, nvars, rowp, cols, nwinequality, xs, blx, bux,
                 device=None):
        super().__init__(nvars=nvars, ncon=0, rowp=rowp, cols=cols,
                         nwinequality=nwinequality, device=device)
        self.ptr = ptr
        self.xs, self.blx, self.bux = xs, blx, bux
        self._cw = None

    def eval_obj_con(self, x):
        xnp = self._read(x)
        fobj, fcon, fail = self.ptr._masterFunc(xnp, ["fobj", "fcon"])
        # kept with its point: one _masterFunc call per point
        self._cw = (xnp, -np.atleast_1d(fcon))
        empty = self._put(np.zeros(0))
        return self._put(np.nan if fail else float(fobj)), empty

    def eval_sparse_con(self, x):
        xnp = self._read(x)
        if self._cw is not None and np.array_equal(self._cw[0], xnp):
            return self._put(self._cw[1])
        _, fcon, _ = self.ptr._masterFunc(xnp, ["fobj", "fcon"])
        return self._put(-np.atleast_1d(fcon))

    def eval_obj_con_gradient(self, x):
        gobj, gcon, fail = self.ptr._masterFunc(self._read(x),
                                                ["gobj", "gcon"])
        self._data = -np.asarray(gcon, dtype=np.float64).reshape(-1)
        return (self._put(np.asarray(gobj).reshape(self.nvars)),
                self._put(np.zeros((0, self.nvars))))

    def eval_sparse_jacobian_data(self, x):
        """The values of the last gradient evaluation."""
        return self._data


class ParOpt(_PyOptOptimizer):
    """pyOptSparse-compatible optimizer class backed by this framework
    (`paropt_pyoptsparse.py:156-430`'s role).

    ``sparse=True`` routes every pyOptSparse constraint through the CSR
    sparse-constraint path (the reference's ParOptSparseProblem leg); the
    default treats them as dense global constraints.  ``device`` holds the
    solver's tensors (None: the card)."""

    def __init__(self, raiseError=True, options={}, sparse=False,
                 device=None):
        self.sparse = sparse
        self.device = device
        # every framework option as a pyoptsparse option
        defOpts = {}
        for desc in make_options().descriptors():
            defOpts[desc.name] = [type(desc.default)
                                  if desc.default is not None else str,
                                  desc.default]
        # pyoptsparse requires non-None defaults for these
        defOpts["ip_checkpoint_file"] = [str, "default.out"]
        defOpts["problem_name"] = [str, "problem"]
        if sparse:
            # the trust region does not support sparse constraints
            defOpts["algorithm"] = [str, "ip"]
        # explicitly set options, collected through _on_setOption
        self.set_options = {}
        super().__init__("ParOpt", "Local Optimizer", defaultOptions=defOpts,
                         informs={}, options=options)
        self.jacType = "csr" if sparse else "dense2d"

    def __call__(self, optProb, sens=None, sensStep=None, sensMode=None,
                 storeHistory=None, hotStart=None, storeSens=True):
        if self.sparse and \
                str(self.set_options.get("algorithm", "ip")).lower() == "tr":
            raise ValueError(
                "Trust region algorithm does not support sparse "
                "constraints; use the interior point or MMA algorithms")
        self.startTime = datetime.datetime.now()
        self.callCounter = 0
        self.storeSens = storeSens

        self.unconstrained = len(optProb.constraints) == 0
        if self.unconstrained:
            # a dummy constraint keeps the problem's shape uniform
            # (`paropt_pyoptsparse.py:276-280`)
            optProb.dummyConstraint = True
        self.optProb = optProb
        self.optProb.finalize()

        self._setHistory(storeHistory, hotStart)
        self._setInitialCacheValues()
        self._setSens(sens, sensStep, sensMode)
        blx, bux, xs = self._assembleContinuousVariables()
        xs = np.minimum(np.maximum(xs, blx), bux)
        nvars = len(xs)

        if self.unconstrained:
            ncon, nineq = 1, 1
            indices = [0]
        else:
            # inequalities first: the trailing ncon - ninequality
            # constraints are equalities (`paropt_pyoptsparse.py:306-318`)
            ineq, _, _, _ = self.optProb.getOrdering(
                ["ni", "li"], oneSided=True)
            nineq = len(ineq)
            indices, blc, buc, fact = self.optProb.getOrdering(
                ["ni", "li", "ne", "le"], oneSided=True)
            ncon = len(indices)
            self.optProb.jacIndices = indices
            self.optProb.fact = fact
            self.optProb.offset = buc

        if self.sparse and not self.unconstrained:
            # the CSR pattern of the ordered constraint Jacobian
            # (`paropt_pyoptsparse.py:324-334`)
            from pyoptsparse.pyOpt_utils import ICOL, IROW, extractRows
            gcon = {name: con.jac
                    for name, con in self.optProb.constraints.items()}
            jac = extractRows(self.optProb.processConstraintJacobian(gcon),
                              indices)
            prob = _SparseAdapter(self, nvars, jac["csr"][IROW],
                                  jac["csr"][ICOL], nineq, xs, blx, bux,
                                  device=self.device)
        else:
            prob = _DenseAdapter(self, nvars, ncon, nineq, xs, blx, bux,
                                 device=self.device)

        registry = make_options()
        opt = _FrameworkOptimizer(prob, {k: v for k, v in
                                         self.set_options.items()
                                         if k in registry})
        result = opt.optimize()
        x, z, zw, zl, zu = (prob.syncs.array(v)
                            for v in opt.get_optimized_point())

        sol_inform = {"value": int(result.get("converged", False)),
                      "text": result.get("reason", "")}
        fobj, fcon, fail = self._masterFunc(x, ["fobj", "fcon"])
        opt_time = (datetime.datetime.now() - self.startTime).total_seconds()
        # sign-flipped multipliers: the framework solves c(x) >= 0 where
        # pyOptSparse has g(x) = -c(x) <= 0 (`paropt_pyoptsparse.py:383-408`)
        mult = zw if self.sparse else z
        multipliers = -mult if mult.size else []
        try:
            sol = self._createSolution(opt_time, sol_inform, fobj, x,
                                       multipliers=multipliers)
        except TypeError:  # an older pyoptsparse without multipliers=
            sol = self._createSolution(opt_time, sol_inform, fobj, x)
        return sol

    def _on_setOption(self, name, value):
        self.set_options[name] = value
