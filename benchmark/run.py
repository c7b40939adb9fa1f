#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, on the CUDA device(s) of this
machine, from the root of a checkout:

    python3 benchmark/run.py --workload sift1m.g1 --seed 7 --seconds 51 \
        --trace 0

The cells are BENCHMARK.json's `workloads`. The last line of standard
output is one JSON object: correct, attempted, failed, metrics (the cell's
end-to-end metrics with --trace 0, its per-layer metrics with --trace 1),
device, with --trace 1 breakdown, and last `checks`, each number the check
compared beside its limit; the same numbers are the last lines of standard
error. Without a CUDA device (or with fewer than the cell asks for), or
where the port cannot be imported, it prints no result and exits nonzero;
so it does if, once the window has closed, the process holds a module of
jax, jaxlib, flax or the JAX package (`pacmann_tpu`).

Build caches stay inside the checkout at fixed paths: the port's nvcc
builds in pacmann_tpu_torch/build/ (its own choice), Triton's and torch's
extension caches under .bench_cache/.
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cache = ROOT / ".bench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    sys.path.insert(1, str(ROOT))
    try:
        import pacmann_tpu_torch  # noqa: F401
        import torch
        from pbench import harness
    except ImportError as exc:
        print(f"cannot import the port or the harness: {exc}",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs only on the card",
              file=sys.stderr)
        return 3
    try:
        result = harness.run_cell(ROOT, args.workload, args.seed,
                                  args.seconds, bool(args.trace),
                                  t_start=T_START)
    except harness.NoDevice as exc:
        print(exc, file=sys.stderr)
        return 3
    found = harness.forbidden_modules(sys.modules)
    if found:
        print(f"the process holds modules of {found}", file=sys.stderr)
        return 4
    for line in harness.check_lines(result):
        print(line, file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
