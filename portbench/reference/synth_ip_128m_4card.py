"""Plain reference of `configs/synth_ip_128m_4card.json`: the synthetic
topology problem and ParOpt's interior-point residual of
`reference/synth_ip_16m.py`, at 2^27 variables.  The reference holds the
design whole: the check joins the ranks' shards first.

numpy and torch only; nothing of the program.
"""

from .synth_ip_16m import SyntheticTopology

__all__ = ["SyntheticTopology"]
