"""Problem models ported from paropt_tpu.models."""

from . import analytic
from .fem_topology import DMOFEMTopology, FEMTopology
from .fem_frequency import FrequencyTopology, FrequencyTopology3D
from .fem_topology3d import DMOFEMTopology3D, FEMTopology3D
from .topology import SyntheticTopology

__all__ = ["SyntheticTopology", "FEMTopology", "DMOFEMTopology",
           "FEMTopology3D", "DMOFEMTopology3D", "FrequencyTopology",
           "FrequencyTopology3D", "analytic"]
