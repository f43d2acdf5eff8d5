"""The reference's fill-callback Python surface (counterpart of
paropt_tpu/compat.py).

The reference's Python module (`paropt/ParOpt.pyx`) has users subclass
``ParOpt.Problem`` with fill-style numpy callbacks:

    class MyProblem(ParOpt.Problem):
        def __init__(self):
            super().__init__(comm, nvars=..., ncon=...)
        def getVarsAndBounds(self, x, lb, ub):  x[:] = ...; lb[:] = ...
        def evalObjCon(self, x):                return fail, fobj, con
        def evalObjConGradient(self, x, g, A):  g[:] = ...; A[i][:] = ...

Reference scripts port with only the import changed:

    from paropt_torch import compat as ParOpt
    opt = ParOpt.Optimizer(problem, options)
    opt.optimize()

``comm`` is accepted and ignored.  The sparse-constraint variants mirror
`ParOpt.pyx:787-907`: the block callbacks (``nwcon`` / ``nwblock`` with
``evalSparseCon``, ``addSparseJacobian``, ``addSparseJacobianTranspose``
and ``addSparseInnerProduct``) take the host IP's callback path, and
``rowp=`` / ``cols=`` the general-CSR path of `problem.CSRSparseProblem`.

The solver's iterates stay on ``device`` (the card unless the caller names
another); each callback reads x to the host as a read-only float64 numpy
array, and its outputs go back to the device.  These are the reference's
own host round trips (`drivers.callbacks.HostIO`), counted by the
problem's ``syncs`` (reads, and the bytes each way), which the host
`InteriorPoint` shares.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from . import problem as _problem
from .dtypes import resolve_device
from .drivers.callbacks import HostIO
from .ip import InteriorPoint as _InteriorPoint
from .mma import MMA as _MMA
from .optimizer import Optimizer as _Optimizer
from .reduced import ReducedProblem
from .tr import QuadraticSubproblem
from .tr import TrustRegion
from .utils.logging import (unpack_mma_output, unpack_output,
                            unpack_tr_2nd_output, unpack_tr_output)

__all__ = ["Problem", "Optimizer", "InteriorPoint", "TrustRegion", "MMA",
           "LBFGS", "LSR1", "CompactQuasiNewton", "QuadraticSubproblem",
           "ReducedProblem", "getOptionsInfo", "printOptionSummary",
           "unpack_checkpoint", "unpack_output", "unpack_tr_output",
           "unpack_tr_2nd_output", "unpack_mma_output", "dtype"]

# `ParOpt.dtype`: the reference's real build is double throughout
dtype = np.float64


def _np(t) -> np.ndarray:
    """A solver result as a numpy array (an accessor, not a callback)."""
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


class Problem(HostIO, _problem.CSRSparseProblem):
    """Reference-style fill-callback problem base class.  ``device`` holds
    the solver's tensors (None: the card)."""

    # numpy callbacks cannot run under torch.func.vmap: the fused loops
    # (use_fused_loop) refuse these problems; the host loops run them
    jit_traceable = False

    def __init__(self, comm=None, nvars: int = 0, ncon: int = 0,
                 num_dense_inequalities: Optional[int] = None,
                 nwcon: int = 0, nwblock: int = 1,
                 num_sparse_constraints: Optional[int] = None,
                 num_sparse_inequalities: Optional[int] = None,
                 rowp=None, cols=None, device=None, **kwargs):
        self.comm = comm  # accepted for signature parity; no MPI here
        if num_sparse_constraints is not None:
            nwcon = num_sparse_constraints
        self._csr = rowp is not None and cols is not None
        if self._csr:
            # general CSR sparse-constraint variant (ParOpt.pyx:837-907)
            super().__init__(nvars=nvars, ncon=ncon, rowp=rowp, cols=cols,
                             ninequality=num_dense_inequalities,
                             nwinequality=num_sparse_inequalities,
                             device=device)
        else:
            # the dense and block-callback variants have no CSR pattern
            _problem.Problem.__init__(
                self, nvars=nvars, ncon=ncon, nwcon=nwcon, nwblock=nwblock,
                ninequality=num_dense_inequalities,
                nwinequality=num_sparse_inequalities)
            self.use_csr_path = False
            self._host_io(device)
        self._cw_cache = None

    # -- reference-style fill callbacks (users override these) --------------
    def getVarsAndBounds(self, x, lb, ub):
        raise NotImplementedError

    def evalObjCon(self, x):
        """-> (fail, fobj, con): the reference's convention."""
        raise NotImplementedError

    def evalObjConGradient(self, x, g, A):
        """Fill g[:] and A[i][:] in place; return fail."""
        raise NotImplementedError

    def evalSparseCon(self, x, out):
        out[:] = 0.0

    def addSparseJacobian(self, alpha, x, px, out):
        raise NotImplementedError

    def addSparseJacobianTranspose(self, alpha, x, pz, out):
        raise NotImplementedError

    def addSparseInnerProduct(self, alpha, x, c, A):
        raise NotImplementedError

    def evalSparseObjCon(self, x, sparse_con):
        """CSR variant: fill sparse_con[:], return (fail, fobj, con)."""
        raise NotImplementedError

    def evalSparseObjConGradient(self, x, g, A, data):
        """CSR variant: fill g[:] and the CSR data[:]; return fail."""
        raise NotImplementedError

    def checkGradients(self, dh=1e-6, x=None, check_hvec_product=False):
        return self.check_gradients(dh, x=x,
                                    check_hvec_product=check_hvec_product)

    # -- adapters to the framework surface ----------------------------------
    def get_vars_and_bounds(self):
        x, lb, ub = (np.zeros(self.nvars) for _ in range(3))
        self.getVarsAndBounds(x, lb, ub)
        return self._put(x), self._put(lb), self._put(ub)

    def eval_obj_con(self, x):
        xnp = self._read(x)
        if self._csr:
            cw = np.zeros(self.nwcon)
            fail, fobj, con = self.evalSparseObjCon(xnp, cw)
            # kept with its point, so eval_sparse_con does not pay a second
            # full user evaluation
            self._cw_cache = (xnp, bool(fail), cw)
        else:
            fail, fobj, con = self.evalObjCon(xnp)
        if fail:
            return (self._put(np.nan),
                    self._put(np.full(self.ncon, np.nan)))
        con = np.asarray(con, dtype=np.float64).reshape(self.ncon)
        return self._put(float(fobj)), self._put(con)

    def eval_obj_con_gradient(self, x):
        xnp = self._read(x)
        g = np.zeros(self.nvars)
        A = [np.zeros(self.nvars) for _ in range(self.ncon)]
        if self._csr:
            data = np.zeros(self.csr_rowp[-1])
            self.evalSparseObjConGradient(xnp, g, A, data)
            self._data = data
        else:
            self.evalObjConGradient(xnp, g, A)
        Amat = np.stack(A) if self.ncon else np.zeros((0, self.nvars))
        return self._put(g), self._put(Amat)

    # -- sparse-constraint surface -------------------------------------------
    def eval_sparse_con(self, x):
        xnp = self._read(x)
        if self._csr:
            hit = self._cw_cache
            if hit is not None and np.array_equal(hit[0], xnp):
                _, fail, cw = hit
            else:
                cw = np.zeros(self.nwcon)
                fail, _, _ = self.evalSparseObjCon(xnp, cw)
            return self._put(np.full(self.nwcon, np.nan) if fail else cw)
        out = np.zeros(self.nwcon)
        self.evalSparseCon(xnp, out)
        return self._put(out)

    def eval_sparse_jacobian_data(self, x):
        """CSR variant: the values the last gradient callback filled."""
        return self._data

    def sparse_jacobian_vec(self, x, px):
        if self._csr:
            return super().sparse_jacobian_vec(x, px)
        out = np.zeros(self.nwcon)
        self.addSparseJacobian(1.0, self._read(x), self._read(px), out)
        return self._put(out)

    def sparse_jacobian_tvec(self, x, zw):
        if self._csr:
            return super().sparse_jacobian_tvec(x, zw)
        out = np.zeros(self.nvars)
        self.addSparseJacobianTranspose(1.0, self._read(x), self._read(zw),
                                        out)
        return self._put(out)

    def sparse_inner_product(self, x, cvec):
        if self._csr:
            return super().sparse_inner_product(x, cvec)
        nb = self.nwblock
        A = np.zeros((self.nwcon // nb, nb, nb))
        self.addSparseInnerProduct(1.0, self._read(x), self._read(cvec),
                                   A.reshape(-1) if nb == 1 else A)
        return self._put(A)

    def sparse_jacobian(self, x):
        if self._csr:
            return super().sparse_jacobian(x)
        # the block callbacks give products, not a pattern: the host IP
        # takes its callback path on this signal
        raise NotImplementedError(
            "block sparse callbacks: the products come from "
            "addSparseJacobian / addSparseJacobianTranspose / "
            "addSparseInnerProduct")


class Optimizer(_Optimizer):
    """`ParOpt.Optimizer(problem, options)` (ParOpt.pyx:1461-1522)."""

    def __init__(self, problem, options: Optional[Dict[str, Any]] = None):
        super().__init__(problem, dict(options) if options else {})

    def getOptimizedPoint(self):
        return tuple(_np(v) for v in self.get_optimized_point())

    def setTrustRegionSubproblem(self, subproblem):
        """Install a custom TR subproblem (the eigenvalue path's entry,
        `ParOptOptimizer.cpp:226-237`)."""
        return self.set_trust_region_subproblem(subproblem)


class InteriorPoint(_InteriorPoint):
    """The host interior point with the reference's camelCase accessors
    (ParOpt.pyx:1229-1365)."""

    def getOptimizedPoint(self):
        return tuple(_np(v) for v in self.get_optimized_point())

    def getOptimizedSlacks(self):
        """-> (s, t, sw, tw) (ParOpt.pyx:1291-1310)."""
        return tuple(_np(v) for v in self.get_optimized_slacks())

    def checkGradients(self, dh):
        return self.problem.check_gradients(dh)

    def setPenaltyGamma(self, gamma):
        return self.set_penalty_gamma(gamma)

    def setMultiplePenaltyGamma(self, gamma):
        """One gamma per dense constraint (ParOpt.pyx:1330-1340)."""
        return self.set_penalty_gamma(np.asarray(gamma, dtype=float))

    def getBarrierParameter(self):
        return self.get_barrier_parameter()

    def setBarrierParameter(self, mu):
        return self.set_barrier_parameter(mu)

    def getComplementarity(self):
        return self.get_complementarity()

    def writeSolutionFile(self, path):
        return self.write_solution_file(path)

    def readSolutionFile(self, path):
        return self.read_solution_file(path)

    def getIterationCounters(self):
        return self.get_iteration_counters()

    def resetDesignAndBounds(self):
        return self.reset_design_and_bounds()

    def resetQuasiNewtonHessian(self):
        return self.reset_quasi_newton_hessian()

    def setQuasiNewton(self, qn):
        """Install a `CompactQuasiNewton` (ParOpt.pyx:1347-1351); None
        runs without one."""
        self.set_quasi_newton_holder({"state": None} if qn is None
                                     else qn.holder)


class MMA(_MMA):
    """The host MMA with the reference's accessors (ParOpt.pyx:1376-1394)."""

    def getAsymptotes(self):
        return tuple(_np(v) for v in self.get_asymptotes())

    def getDesignHistory(self):
        return tuple(_np(v) for v in self.get_design_history())


# quasi-Newton enum constants (`ParOpt.pyx:52-59`), usable as the
# update_type / diag_type arguments of LBFGS / LSR1
SKIP_NEGATIVE_CURVATURE = "skip_negative_curvature"
DAMPED_UPDATE = "damped_update"
YTY_OVER_YTS = "yty_over_yts"
YTS_OVER_STS = "yts_over_sts"
INNER_PRODUCT_YTY_OVER_YTS = "inner_yty_over_yts"
INNER_PRODUCT_YTS_OVER_STS = "inner_yts_over_sts"


class CompactQuasiNewton:
    """Reference-style limited-memory Hessian object (`ParOpt.pyx:
    1190-1227`): holds a `QNState` in a holder dict that
    `InteriorPoint.setQuasiNewton` installs, and supports direct
    `update` / `mult` / `multAdd` driving (the `examples/limited_memory_test`
    usage mode).  float64, on the problem's device."""

    _qn_type = "bfgs"

    def __init__(self, problem, subspace: int = 10,
                 update_type: str = SKIP_NEGATIVE_CURVATURE,
                 diag_type: str = YTY_OVER_YTS,
                 storage_dtype: str = "auto"):
        """``storage_dtype``: 'auto', 'native' or 'bfloat16' (the
        `qn_storage_dtype` option)."""
        from .ip import _resolve_qn_storage
        from .ops.qn import qn_init
        self._device = resolve_device(getattr(problem, "_device", None))
        self.holder = {"state": qn_init(
            subspace, problem.nvars, dtype=torch.float64,
            qn_type=self._qn_type, update_type=update_type,
            diag_type=diag_type,
            storage_dtype=_resolve_qn_storage(storage_dtype, torch.float64),
            device=self._device)}

    def _tensor(self, a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64),
                               device=self._device)

    def reset(self):
        from .ops.qn import qn_reset
        self.holder["state"] = qn_reset(self.holder["state"])

    def update(self, s, y):
        """Apply one (s, y) pair (`ParOpt.pyx:1198-1200`); -> (skipped,
        damped)."""
        from .ops.qn import qn_update
        self.holder["state"], skipped, damped = qn_update(
            self.holder["state"], self._tensor(s), self._tensor(y))
        return int(skipped), int(damped)

    def mult(self, x, y=None):
        """y = B @ x; fills ``y`` in place when given an array
        (`ParOpt.pyx:1202-1204`), else returns the product."""
        from .ops.qn import qn_mult
        out = _np(qn_mult(self.holder["state"], self._tensor(x)))
        if y is not None:
            y[:] = out
            return None
        return out

    def multAdd(self, alpha, x, y):
        """y += alpha * B @ x (`ParOpt.pyx:1206-1208`)."""
        y[:] = np.asarray(y) + alpha * self.mult(x)


class LBFGS(CompactQuasiNewton):
    """`ParOpt.pyx:1210-1219`."""
    _qn_type = "bfgs"


class LSR1(CompactQuasiNewton):
    """`ParOpt.pyx:1221-1227` (no update_type: SR1 has one update rule
    with its curvature skip test built in)."""
    _qn_type = "sr1"

    def __init__(self, problem, subspace: int = 10,
                 diag_type: str = YTY_OVER_YTS):
        super().__init__(problem, subspace, diag_type=diag_type)


def unpack_checkpoint(filename):
    """A file of `writeSolutionFile` as the reference's tuple
    (`ParOpt.pyx:318-355`): (barrier, s, z, x, zl, zu).  The files are
    npz, as the JAX package writes them."""
    if not filename.endswith(".npz"):
        filename = filename + ".npz"
    with np.load(filename) as dat:
        return (float(dat["mu"]), dat["s"], dat["z"], dat["x"], dat["zl"],
                dat["zu"])


def printOptionSummary():
    """Print a summary of every option of every optimizer
    (`ParOpt.pyx:417-425`)."""
    info = getOptionsInfo()
    for name in info:
        print(info[name].descript)


class _OptionInfo:
    """One entry of `getOptionsInfo` (`ParOpt.pyx:447-518`): option_type,
    default, values and descript."""

    def __init__(self, desc):
        self.name = desc.name
        self.option_type = desc.otype if desc.otype != "enum" else "str"
        self.default = desc.default
        if desc.otype == "enum":
            self.values = list(desc.values)
        elif desc.low is not None:
            self.values = [desc.low, desc.high]
        else:
            self.values = None
        self.descript = desc.doc

    def __repr__(self):
        return (f"OptionInfo({self.name}: {self.option_type}, "
                f"default={self.default!r})")


def getOptionsInfo():
    """{name: info} over every registered option; the drivers declare
    their own options from it (`ParOpt.pyx:447-518`,
    `paropt_driver.py:51-92`, `paropt_pyoptsparse.py:164-190`)."""
    from .utils.options import make_options
    return {d.name: _OptionInfo(d) for d in make_options().descriptors()}
