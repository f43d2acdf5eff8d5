"""Vector, quasi-Newton, KKT and kernel layers of paropt_torch."""
