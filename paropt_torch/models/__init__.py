"""Problem models ported from paropt_tpu.models."""

from . import analytic
from .fem_topology import DMOFEMTopology, FEMTopology
from .fem_topology3d import DMOFEMTopology3D, FEMTopology3D
from .topology import SyntheticTopology

__all__ = ["SyntheticTopology", "FEMTopology", "DMOFEMTopology",
           "FEMTopology3D", "DMOFEMTopology3D", "analytic"]
