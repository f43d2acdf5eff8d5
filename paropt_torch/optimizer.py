"""Unified optimizer facade (counterpart of paropt_tpu/optimizer.py).

One entry point that dispatches on the ``algorithm`` option ('ip' | 'tr' |
'mma') and exposes the optimized point uniformly
(`ParOptOptimizer.cpp:65-221`).  Ported so far: the ``use_fused_loop``
routes of 'ip' (`ip_fused.fused_ip_optimize`), 'tr' (`tr.FusedTR`) and
'mma' (`mma.FusedMMA`).  Every other route raises NotImplementedError
naming its ROADMAP item.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from .utils.options import OptionRegistry, make_options

__all__ = ["Optimizer"]

_UNPORTED = {
    ("tr", False): "the host-loop TrustRegion is not ported yet "
                   "(ROADMAP queue 1 item 11)",
    ("ip", False): "the host-loop InteriorPoint is not ported yet "
                   "(ROADMAP queue 1 item 11); use use_fused_loop=True",
    ("mma", False): "the host-loop MMA is not ported yet "
                    "(ROADMAP queue 1 item 11); use use_fused_loop=True",
}


class Optimizer:
    def __init__(self, problem, options: Optional[Any] = None):
        self.problem = problem
        if isinstance(options, OptionRegistry):
            self.options = options
        else:
            self.options = make_options(options, which="facade")
        self.algorithm = self.options["algorithm"]
        self._inner = None
        self._fused_state = None
        self._result: Optional[Dict[str, Any]] = None

    def optimize(self) -> Dict[str, Any]:
        algo = self.options["algorithm"]
        fused = self.options["use_fused_loop"]
        if (algo, fused) in _UNPORTED:
            raise NotImplementedError(_UNPORTED[(algo, fused)])
        if algo == "ip":
            from .ip_fused import fused_ip_optimize
            self._result, self._fused_state = fused_ip_optimize(
                self.problem, self.options)
        else:
            if algo == "tr":
                from .tr import FusedTR as solver
            else:
                from .mma import FusedMMA as solver
            self._inner = solver(self.problem, self.options)
            self._result, self._fused_state = self._inner.solve()
        return self._result

    def get_optimized_point(self):
        """-> (x, z, zw, zl, zu) like `ParOptOptimizer::getOptimizedPoint`."""
        st = self._fused_state
        if st is None:
            raise RuntimeError("call optimize() first")
        if self.algorithm == "ip":
            v = st.vars
            return v.x, v.z, v.zw, v.zl, v.zu
        if self.algorithm == "mma":
            return st.x, st.z, st.zw, st.zl, st.zu
        raise RuntimeError(
            "multipliers live inside FusedTR's inner QP solves; the host "
            "TrustRegion (use_fused_loop=False), which exposes them, is not "
            "ported yet (ROADMAP queue 1 item 11)")

    @property
    def result(self) -> Optional[Dict[str, Any]]:
        return self._result
