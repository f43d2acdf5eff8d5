"""Trust region (counterpart of paropt_tpu/tr.py).  Only the registry ->
`FusedIPOptions` mapping is ported so far; it is shared by the facade's
fused IP solve and, once ported, by `FusedTR`'s inner solves."""

from __future__ import annotations

from .ip_fused import FusedIPOptions

__all__ = ["_fused_ip_options"]


def _fused_ip_options(o, barrier: str, start: str,
                      slm: bool) -> FusedIPOptions:
    """Map the registry's IP options onto the inner fused-IP solver's
    options (forced overrides per `sl1qpOptimize`,
    `ParOptTrustRegion.cpp:1490-1500`: use_quasi_newton_update off, the
    outer loop owns the QN update).  'default' resolves to affine_step and
    to the main barrier strategy."""
    if start == "default":
        start = "affine_step"
    if barrier == "default":
        barrier = o["barrier_strategy"]
    return FusedIPOptions(
        abs_res_tol=o["abs_res_tol"],
        init_barrier_param=o["init_barrier_param"],
        monotone_barrier_fraction=o["monotone_barrier_fraction"],
        monotone_barrier_power=o["monotone_barrier_power"],
        rel_bound_barrier=o["rel_bound_barrier"],
        min_fraction_to_boundary=o["min_fraction_to_boundary"],
        penalty_descent_fraction=o["penalty_descent_fraction"],
        min_rho_penalty_search=o["min_rho_penalty_search"],
        armijo_constant=o["armijo_constant"],
        function_precision=o["function_precision"],
        design_precision=o["design_precision"],
        max_line_iters=o["max_line_iters"],
        use_backtracking_alpha=o["use_backtracking_alpha"],
        max_major_iters=o["max_major_iters"],
        iterative_refinement_steps=o["iterative_refinement_steps"],
        qn_sigma=o["qn_sigma"],
        barrier_strategy=barrier,
        starting_point_strategy=start,
        start_affine_multiplier_min=o["start_affine_multiplier_min"],
        use_line_search=o["use_line_search"],
        use_quasi_newton_update=False,
        sequential_linear_method=slm,
        norm_type=o["norm_type"])
