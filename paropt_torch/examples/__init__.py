"""The repo's example programs (``examples/*.py``) on the port, one module
per script with the same name.  Each runs with
``python -m paropt_torch.examples.<name> [--device cpu] [flags]``, parses
the script's own flags, prints what it prints and returns those numbers
from ``main(argv=None)``.  Each runs on the CUDA card unless given
``--device cpu``; a script that picks float32 on the accelerator and
float64 on the CPU keeps that rule, the others run in the port's default
float64.  Plots are drawn only with ``-o`` and only if matplotlib
imports."""
