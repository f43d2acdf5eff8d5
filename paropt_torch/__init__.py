"""paropt_torch — the PyTorch/CUDA port of paropt_tpu.

The port mirrors paropt_tpu's module names so each piece has an obvious
counterpart:

- ``dtypes``, ``ops.veclib``: dtype resolution and vector reductions;
- ``problem``, ``models.topology``: the Problem protocol (autodiff through
  ``torch.func``) and the synthetic topology workload;
- ``ops.qn``, ``ops.kkt``: the compact quasi-Newton state and the KKT
  factor/solve;
- ``ip_fused``: the fused interior-point major iteration and its host loop;
- ``ops.kernels``: hand-written CUDA kernels for Hopper (``csrc/*.cu``)
  that replace the three Pallas kernels of ``paropt_tpu/ops/
  pallas_kernels.py``, each beside its plain PyTorch version;
- ``convert``: numpy-dict conversion of paropt_tpu states into the port's.

The package imports torch and numpy only, never jax.  Nothing here sets a
global default dtype; every constructor takes an explicit device and dtype.
"""

from .dtypes import default_float, resolve_dtype
from .problem import Problem, SparseJacobian
from .ops.qn import QNState, qn_init
from .ip_fused import FusedIP

__all__ = ["Problem", "SparseJacobian", "QNState", "qn_init", "FusedIP",
           "default_float", "resolve_dtype"]

__version__ = "0.1.0"
