"""Private-search CLI — the main end-to-end binary, the port of the JAX
package's cli/private_search.py.

Flag-for-flag port of the reference's private-search.go:72-103 (C13):
`python -m pacmann_tpu_torch.cli.private_search -n 1000 -d 128 -m 32 ...`.
With no -input, the vectors and queries are synthetic (private-search.go:
105-124). A run without an existing -graph file builds the graph
(graph/build.py); with -input and no -graph it is cached as
{data}_{n}_{dim}_{m}_graph.npy beside the input, with its aux record.

-device takes the engines' torch device ("-device" alone: "cuda"); without
it they run on the card, which raises where there is none.
"""

from __future__ import annotations

import argparse

from pacmann_tpu_torch.private.driver import PrivateSearchConfig, run_private_search


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="pacmann-private-search",
        description="private approximate nearest neighbor search on the "
                    "GPU (PyTorch + CUDA)",
    )
    p.add_argument("-n", type=int, default=1000, help="number of vectors")
    p.add_argument("-d", "--dim", type=int, default=128, help="dimension")
    p.add_argument("-m", type=int, default=32, help="graph degree")
    p.add_argument("-k", type=int, default=10, help="top-k")
    p.add_argument("-q", type=int, default=100, help="number of queries")
    p.add_argument("-input", default="", help="vector file (bvecs/fvecs/npy/txt)")
    p.add_argument("-graph", default="", help="graph file (npy/txt/ivecs)")
    p.add_argument("-query", default="", help="query file")
    p.add_argument("-output", default="", help="answers output file")
    p.add_argument("-gnd", default="", help="ground-truth file")
    p.add_argument("-report", default="", help="report file (appended)")
    p.add_argument("-step", type=int, default=20, help="max beam-search rounds")
    p.add_argument("-parallel", type=int, default=3, help="beam width per round")
    p.add_argument("-benchmark", action="store_true",
                   help="skip PIR prep; fixed random access pattern")
    p.add_argument("-rtt", type=float, default=50.0, help="modeled RTT (ms)")
    p.add_argument("-nonprivate", action="store_true", help="bypass PIR")
    p.add_argument("-fail", type=int, default=8, help="FailureProbLog2")
    p.add_argument("-device", nargs="?", const="cuda", default=None,
                   help="torch device of the PIR engines (default: the card)")
    p.add_argument("-engine", default="fused", choices=["fused", "simple", "device", "device-fused"],
                   help="batch PIR engine (fused = one device scan per batch)")
    p.add_argument("-concurrent", type=int, default=1,
                   help="queries advanced in lockstep per oracle batch")
    p.add_argument("-profile", default="",
                   help="torch.profiler trace dir; the trace carries the "
                        "program's pacmann.* spans")
    p.add_argument("-seed", type=int, default=0)
    p.add_argument("-verbose", action="store_true")
    p.add_argument("-starts", default="random", choices=["random", "centroid"],
                   help="start-vertex selection: reference-style random "
                        "sqrt(n), or k-means-centroid coverage")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    cfg = PrivateSearchConfig(
        n=args.n, dim=args.dim, m=args.m, k=args.k, q=args.q,
        input_file=args.input, graph_file=args.graph, query_file=args.query,
        output_file=args.output, gnd_file=args.gnd, report_file=args.report,
        max_step=args.step, parallel=args.parallel,
        benchmarking=args.benchmark, rtt_ms=args.rtt,
        non_private=args.nonprivate, failure_prob_log2=args.fail,
        device=args.device, engine=args.engine, concurrent=args.concurrent,
        profile_dir=args.profile, seed=args.seed, verbose=args.verbose,
        start_mode=args.starts,
    )
    res = run_private_search(cfg)
    print(res.report.render())
    print(f"Success rate: {res.success_rate:.4f}")
    print(f"Maintenance time total (s): {res.maintenance_time_s:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
