"""Framework driver integrations (counterpart of paropt_tpu/drivers; the
reference's pure-Python layer):

- `callbacks.FunctionProblem`: a Problem from plain Python/numpy callables
  (the adapter the drivers below build on);
- `pyoptsparse_driver.ParOpt`: a pyOptSparse Optimizer subclass
  (`paropt/paropt_pyoptsparse.py`'s role); requires pyoptsparse;
- `openmdao_driver.ParOptDriver`: an OpenMDAO Driver subclass
  (`paropt/paropt_driver.py`'s role); requires openmdao;
- `openmdao_sparse_driver.ParOptSparseDriver`: the OpenMDAO driver with
  the separable sparse-constraint path (`paropt/paropt_sparse_driver.py`'s
  role), which feeds the general-CSR path; requires openmdao.
"""

from .callbacks import FunctionProblem  # noqa: F401
