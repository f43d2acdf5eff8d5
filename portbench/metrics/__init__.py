"""One reader per metric: ``read(run, part, traffic)`` returns the value,
or None where the run holds nothing for it (the harness then leaves the
metric out).  A dotted metric name is read by the module named before the
dot, which receives the rest as ``part``."""
