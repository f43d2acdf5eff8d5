"""Problem models ported from paropt_tpu.models."""

from . import analytic
from .brachistochrone import BrachistochroneCollocation
from .cartpole import CartPole
from .cops import Electron, ElectronCSR, Polygon
from .fem_topology import DMOFEMTopology, FEMTopology
from .fem_frequency import FrequencyTopology, FrequencyTopology3D
from .fem_topology3d import DMOFEMTopology3D, FEMTopology3D
from .ssto import SSTOCollocation
from .topology import SyntheticTopology
from .truss import DMOTruss, TrussSizing

__all__ = ["SyntheticTopology", "FEMTopology", "DMOFEMTopology",
           "FEMTopology3D", "DMOFEMTopology3D", "FrequencyTopology",
           "FrequencyTopology3D", "Electron", "ElectronCSR", "Polygon",
           "BrachistochroneCollocation", "SSTOCollocation", "TrussSizing",
           "DMOTruss", "CartPole", "analytic"]
