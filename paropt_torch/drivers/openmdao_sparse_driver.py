"""OpenMDAO driver with the separable sparse-constraint path (counterpart
of paropt_tpu/drivers/openmdao_sparse_driver.py; the role of
`paropt/paropt_sparse_driver.py:8-50`).

`ParOptSparseDriver` extends `ParOptDriver`: constraints named in
``set_sparse_constraints(names)`` go to the framework's separable sparse
constraints (cw(x) >= 0 with a CSR Jacobian) instead of the dense ``ncon``
block.  The CSR pattern is the constraint's total-derivative coloring
sparsity when OpenMDAO has computed one, dense rows otherwise.  The
interior point then factors Cw = C0 + Aw·D⁻¹·Awᵀ with the native sparse
Cholesky (`ops.sparse_native`) while the few global constraints stay
dense: the path dymos users reach.

Requires `openmdao`; importing this module without it raises ImportError.
"""

from __future__ import annotations

import numpy as np

from ..problem import CSRSparseProblem
from .openmdao_driver import (ParOptDriver, _OpenMDAOProblem, _shift,
                              _sign)

__all__ = ["ParOptSparseDriver"]


class _OpenMDAOSparseProblem(CSRSparseProblem):
    """An OpenMDAO problem with designated separable constraints presented
    as a `CSRSparseProblem`; the dense constraints and the design
    variables go through an `_OpenMDAOProblem` that shares its ``syncs``."""

    def __init__(self, om_prob, driver, sparse_names, device=None):
        self.om_prob = om_prob
        self.driver = driver
        con_meta = driver._cons
        # inequalities first in BOTH groups: the trailing constraints of
        # each are equalities (dymos defects arrive as sparse equals= rows)
        sp = [n for n in con_meta if n in sparse_names]
        sp_ineq = [n for n in sp if con_meta[n]["equals"] is None]
        self._sparse_names = sp_ineq + [n for n in sp if n not in sp_ineq]
        dense = _OpenMDAOProblem(
            om_prob, _DenseView(driver, {n: m for n, m in con_meta.items()
                                         if n not in sparse_names}), device)
        self._dense = dense
        rowp, cols = self._sparse_pattern(dense.nvars)
        super().__init__(
            nvars=dense.nvars, ncon=dense.ncon, rowp=rowp, cols=cols,
            ninequality=dense.ninequality,
            nwinequality=sum(int(con_meta[n]["size"]) for n in sp_ineq),
            device=device)
        self.syncs = dense.syncs

    # -- pattern discovery ---------------------------------------------------
    def _sparse_pattern(self, nvars):
        """CSR pattern of the sparse-constraint Jacobian: per-constraint
        declared sparsity when OpenMDAO exposes it, dense rows otherwise."""
        meta = self.driver._cons
        rowp, cols = [0], []
        for name in self._sparse_names:
            size = int(meta[name]["size"])
            rows_cols = None
            try:  # total-derivative coloring sparsity, if computed
                coloring = self.driver._coloring_info.coloring
                if coloring is not None:
                    rows_cols = coloring.get_subjac_sparsity().get(name)
            except AttributeError:
                rows_cols = None
            if rows_cols is None:
                for _ in range(size):
                    cols.extend(range(nvars))
                    rowp.append(len(cols))
            else:
                per_row = [[] for _ in range(size)]
                for _, (r_idx, c_idx, _shape) in rows_cols.items():
                    for r, c in zip(np.atleast_1d(r_idx),
                                    np.atleast_1d(c_idx)):
                        per_row[int(r)].append(int(c))
                for r in range(size):
                    cols.extend(sorted(set(per_row[r])))
                    rowp.append(len(cols))
        return (np.asarray(rowp, dtype=np.int32),
                np.asarray(cols, dtype=np.int32))

    # -- framework Problem surface -------------------------------------------
    def _scatter_dv(self, x):
        self._dense._scatter_dv(x)

    def get_vars_and_bounds(self):
        return self._dense.get_vars_and_bounds()

    def eval_obj_con(self, x):
        return self._dense.eval_obj_con(x)

    def eval_obj_con_gradient(self, x):
        return self._dense.eval_obj_con_gradient(x)

    def eval_sparse_con(self, x):
        self._dense._run_at(x)
        meta = self.driver._cons
        cons = self.driver.get_constraint_values()
        rows = [_shift(meta[n], np.atleast_1d(cons[n]).ravel())
                for n in self._sparse_names]
        return self._dense._put(np.concatenate(rows) if rows
                                else np.zeros(0))

    def eval_sparse_jacobian_data(self, x):
        self._dense._run_at(x)
        totals = self.om_prob.compute_totals(
            of=self._sparse_names, wrt=self._dense._dv_names,
            return_format="array")
        meta = self.driver._cons
        data = np.zeros(self.csr_rowp[-1])
        off_row = pos = 0
        for name in self._sparse_names:
            size = int(meta[name]["size"])
            sign = _sign(meta[name])
            for r in range(size):
                sl = slice(self.csr_rowp[pos], self.csr_rowp[pos + 1])
                data[sl] = sign * totals[off_row + r][self.csr_cols[sl]]
                pos += 1
            off_row += size
        return data


class _DenseView:
    """The driver as the dense adapter sees it: only the constraints that
    stay dense."""

    def __init__(self, driver, dense_cons):
        self._driver = driver
        self._cons = dense_cons

    def __getattr__(self, name):
        return getattr(self._driver, name)


class ParOptSparseDriver(ParOptDriver):
    """OpenMDAO driver routing designated constraints through the separable
    sparse path (`paropt_sparse_driver.py`'s role)."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self._sparse_con_names = set()

    def set_sparse_constraints(self, names):
        """Mark OpenMDAO constraint names as separable sparse constraints."""
        self._sparse_con_names = set(names)

    def _adapter(self):
        return _OpenMDAOSparseProblem(self._problem(), self,
                                      self._sparse_con_names,
                                      device=self.options["device"])
