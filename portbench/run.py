"""Entry point of the benchmark: ``python3 portbench/run.py --workload <cell>
--seed <n> --seconds <s> --trace <0|1>`` from the root of the checkout
(see portbench/README.md)."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench.harness import main  # noqa: E402  (the checkout on the path)

if __name__ == "__main__":
    sys.exit(main())
