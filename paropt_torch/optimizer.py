"""Unified optimizer facade (counterpart of paropt_tpu/optimizer.py).

One entry point that dispatches on the ``algorithm`` option ('ip' | 'tr' |
'mma', default 'tr') and exposes the optimized point uniformly
(`ParOptOptimizer.cpp:65-221`).  By default each algorithm runs its host
loop (`ip.InteriorPoint`, `tr.TrustRegion`, `mma.MMA`); ``use_fused_loop``
selects the fused loops (`ip_fused.fused_ip_optimize`, `tr.FusedTR`,
`mma.FusedMMA`).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from .utils.options import OptionRegistry, make_options

__all__ = ["Optimizer"]


class Optimizer:
    def __init__(self, problem, options: Optional[Any] = None):
        self.problem = problem
        if isinstance(options, OptionRegistry):
            self.options = options
        else:
            self.options = make_options(options, which="facade")
        self.algorithm = self.options["algorithm"]
        self._inner = None
        self._subproblem = None
        self._fused_state = None
        self._result: Optional[Dict[str, Any]] = None

    def set_trust_region_subproblem(self, subproblem) -> None:
        """Install a custom TR subproblem
        (`ParOptOptimizer::setTrustRegionSubproblem`,
        `ParOptOptimizer.cpp:226-237`); its solves run the host IP."""
        self._subproblem = subproblem

    def optimize(self) -> Dict[str, Any]:
        algo = self.options["algorithm"]
        if self.options["use_fused_loop"]:
            return self._optimize_fused(algo)
        if algo == "ip":
            from .ip import InteriorPoint
            self._inner = InteriorPoint(self.problem, self.options)
            self._result = self._inner.optimize(
                checkpoint=self.options["ip_checkpoint_file"])
        elif algo == "tr":
            from .tr import TrustRegion
            self._inner = TrustRegion(self.problem, self.options,
                                      subproblem=self._subproblem)
            self._result = self._inner.optimize()
        else:
            from .mma import MMA
            self._inner = MMA(self.problem, self.options)
            self._result = self._inner.optimize()
        return self._result

    def _optimize_fused(self, algo: str) -> Dict[str, Any]:
        if not getattr(self.problem, "jit_traceable", True):
            raise ValueError(
                "use_fused_loop requires a torch-native problem (autodiff "
                "or tensor eval_* methods); fill-callback (compat) problems "
                "run the host loops: drop use_fused_loop")
        if algo == "ip":
            from .ip_fused import fused_ip_optimize
            self._result, self._fused_state = fused_ip_optimize(
                self.problem, self.options)
            return self._result
        if algo == "tr":
            if self._subproblem is not None:
                raise ValueError(
                    "use_fused_loop does not support a custom TR "
                    "subproblem; use the host TrustRegion")
            from .tr import FusedTR as solver
        else:
            from .mma import FusedMMA as solver
        self._inner = solver(self.problem, self.options)
        self._result, self._fused_state = self._inner.solve()
        return self._result

    def get_optimized_point(self):
        """-> (x, z, zw, zl, zu) like `ParOptOptimizer::getOptimizedPoint`.

        For the host 'tr' route the multipliers are those of the host IP
        over the quadratic subproblem, as in the JAX package: its inner
        solves are fused, so that IP keeps its initial multipliers."""
        if self._fused_state is not None:
            st = self._fused_state
            if self.algorithm == "ip":
                v = st.vars
                return v.x, v.z, v.zw, v.zl, v.zu
            if self.algorithm == "mma":
                return st.x, st.z, st.zw, st.zl, st.zu
            raise RuntimeError(
                "multipliers live inside FusedTR's inner QP solves; use the "
                "host TrustRegion (use_fused_loop=False) for "
                "get_optimized_point's multipliers")
        if self._inner is None:
            raise RuntimeError("call optimize() first")
        if self.algorithm == "ip":
            return self._inner.get_optimized_point()
        if self.algorithm == "tr":
            tr = self._inner
            _, z, zw, zl, zu = tr.ip.get_optimized_point()
            return tr.subproblem.xk, z, zw, zl, zu
        mma = self._inner
        return mma.x, mma.z, mma.zw, mma.zl, mma.zu

    @property
    def result(self) -> Optional[Dict[str, Any]]:
        return self._result
