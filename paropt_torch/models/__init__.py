"""Problem models ported from paropt_tpu.models."""

from . import analytic
from .fem_topology import DMOFEMTopology, FEMTopology
from .topology import SyntheticTopology

__all__ = ["SyntheticTopology", "FEMTopology", "DMOFEMTopology", "analytic"]
