#!/usr/bin/env python3
"""The check's readings, run by hand on the card (the benchmark's own runs
never run this): a cell's numbers compared, over many seeds in one
process, from the program as it is (the lower readings) or from the
control (--control, the upper readings).

    python3 benchmark/readings.py --workload sift1m.g1 --seconds 51 \
        --seed 1 2 3 [--control]

The control breaks the precision the configuration states. Search cells
run the program at half the configuration's failure_prob_log2 (its own
cheaper setting: fewer primary hints a chunk), so more routed fetches go
unserved than the configuration's failure bound allows. Prep cells put the
reference in the program's place with its PRF cut to 4 of AES-128's 10
rounds. Prints one JSON line a seed: correct, attempted and the checks.
"""

import argparse
import json
import sys
import time

from run import ROOT, T_START


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(1, str(ROOT))
    from pbench import harness

    t_start = T_START
    for seed in args.seed:
        res = harness.run_cell(ROOT, args.workload, seed, args.seconds,
                               False, control=args.control, t_start=t_start)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": args.control,
                          "correct": res["correct"],
                          "attempted": res["attempted"],
                          "metrics": res["metrics"],
                          "checks": res["checks"]}), flush=True)
        t_start = time.perf_counter()
    return 0


if __name__ == "__main__":
    sys.exit(main())
