"""Problem models ported from paropt_tpu.models."""

from .topology import SyntheticTopology

__all__ = ["SyntheticTopology"]
