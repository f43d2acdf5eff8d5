"""Options registry and the write-output cadence of the fused solvers."""
