#!/usr/bin/env python3
"""Entry of the benchmark: run one cell once (see :mod:`langbench.harness`).

    python3 langbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run it from the root of a checkout; ``python3 -m langbench.run`` works too.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from langbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
