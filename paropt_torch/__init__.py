"""paropt_torch — the PyTorch/CUDA port of paropt_tpu.

The port mirrors paropt_tpu's module names so each piece has an obvious
counterpart:

- ``dtypes``, ``ops.veclib``: dtype resolution and vector reductions;
- ``problem``, ``models``: the Problem protocol (autodiff through
  ``torch.func``) and the general-CSR ``CSRSparseProblem``, the synthetic
  topology workload, the 2-D SIMP compliance models
  (``models.fem_topology``: FEMTopology, DMOFEMTopology), the 3-D voxel
  ones (``models.fem_topology3d``), the frequency-constrained 2-D and 3-D
  models (``models.fem_frequency``), the small analytic problems
  (``models.analytic``), COPS (``models.cops``), the trajectory
  transcriptions (``models.brachistochrone``, ``models.ssto``,
  ``models.cartpole``) and the trusses (``models.truss``);
- ``ops.qn``, ``ops.kkt``: the compact quasi-Newton state and the KKT
  factor/solve; ``ops.sparse_native``: the host sparse Cholesky of the
  general-CSR path, built with g++ from ``src_native/`` at first use;
- ``ip``: the host-loop interior-point method (InteriorPoint);
- ``ip_fused``: the fused interior-point major iteration, its host loop and
  the facade's whole solve;
- ``mma``: the host-loop MMA (MMA) and the fused MMA outer loop (FusedMMA,
  fused_mma_solve);
- ``tr``: the host-loop trust region (TrustRegion, with SL1QP and the
  filter method) and the fused SL1QP trust region (FusedTR), with their
  QP model;
- ``eig``, ``eig_fused``: the compact eigenvalue-constraint path, host
  (EigenSubproblem through TrustRegion) and fused (FusedEigenTR);
  ``ops.lobpcg``: the eigensolver they run, a copy of JAX's LOBPCG;
- ``optimizer``: the ``Optimizer`` facade (host loops by default, the fused
  loops with ``use_fused_loop``); ``utils.options``: the typed option
  registry; ``utils.logging``: the reference's fixed-width logs and their
  parsers;
- ``ops.kernels``: hand-written CUDA kernels for Hopper (``csrc/*.cu``)
  that replace the three Pallas kernels of ``paropt_tpu/ops/
  pallas_kernels.py``, each beside its plain PyTorch version;
- ``convert``: numpy-dict conversion of paropt_tpu states into the port's;
  ``utils.checkpoint``: checkpoints of solver states (``torch.save``);
- ``reduced``: ``ReducedProblem`` (design freezes, non-design regions);
  ``compat``: the reference's fill-callback surface (``ParOpt.Problem``,
  ``ParOpt.Optimizer``, ...); ``drivers``: ``FunctionProblem`` and the
  OpenMDAO and pyOptSparse drivers; ``utils.plot_history``: convergence
  plots from the logs.

The package imports torch and numpy only, never jax.  Nothing here sets a
global default dtype; every constructor takes a device and a dtype, and a device left out
resolves to the CUDA card (``dtypes.resolve_device``).
"""

from .dtypes import default_float, resolve_device, resolve_dtype
from .problem import (CSRSparseProblem, Problem, SparseJacobian,
                      check_gradients)
from .ops.qn import QNState, qn_init
from .ip import InteriorPoint
from .ip_fused import FusedIP, fused_ip_optimize
from .mma import MMA, FusedMMA, fused_mma_solve
from .tr import FusedTR, TrustRegion
from .optimizer import Optimizer
from .utils.options import make_options

__all__ = ["Problem", "SparseJacobian", "CSRSparseProblem",
           "check_gradients", "QNState",
           "qn_init", "InteriorPoint", "FusedIP", "fused_ip_optimize",
           "MMA", "FusedMMA", "fused_mma_solve", "TrustRegion", "FusedTR",
           "Optimizer", "make_options", "default_float", "resolve_dtype",
           "resolve_device"]

__version__ = "0.1.0"


def __getattr__(name):
    # loaded on first use, as in paropt_tpu
    if name == "ReducedProblem":
        from .reduced import ReducedProblem
        return ReducedProblem
    if name == "compat":
        import importlib
        return importlib.import_module(".compat", __name__)
    raise AttributeError(name)
