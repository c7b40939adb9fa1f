#!/usr/bin/env python3
"""The port's headline benchmark: `python bench_torch.py [--device cpu]`,
run as `python bench.py` is, with the same environment knobs
(PACMANN_BENCH_N, PACMANN_BENCH_SMALL, PACMANN_BENCH_BIG,
PACMANN_BENCH_LINEAR). Its logic is pacmann_tpu_torch/bench.py."""

import sys

from pacmann_tpu_torch.bench import main

if __name__ == "__main__":
    sys.exit(main())
