"""Non-private ANN command — plaintext sanity path, the port of the JAX
package's cli/ann.py.

Port of the reference's graphann/cmd/ann/ann.go (C14): build or load the
graph, batched plaintext beam search on the torch engine, recall report.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from pacmann_tpu_torch.graph.beam import PlaintextEngine
from pacmann_tpu_torch.graph.build import build_graph
from pacmann_tpu_torch.graph.recall import brute_force_knn, compute_recall
from pacmann_tpu_torch.io.loaders import (
    load_float32_matrix,
    load_int_matrix,
    save_int_matrix,
)


def main(argv=None, device=None) -> int:
    """device: where the build and the search run (a Python keyword, not a
    flag); None means CUDA, which raises where CUDA is not available."""
    p = argparse.ArgumentParser(prog="pacmann-ann")
    p.add_argument("-n", type=int, default=1000)
    p.add_argument("-d", "--dim", type=int, default=128)
    p.add_argument("-m", type=int, default=32)
    p.add_argument("-k", type=int, default=10)
    p.add_argument("-q", type=int, default=100)
    p.add_argument("-input", default="")
    p.add_argument("-graph", default="")
    p.add_argument("-query", default="")
    p.add_argument("-output", default="")
    p.add_argument("-gnd", default="")
    p.add_argument("-step", type=int, default=20)
    p.add_argument("-parallel", type=int, default=3)
    p.add_argument("-seed", type=int, default=0)
    args = p.parse_args(argv)

    rng = np.random.default_rng(args.seed)
    if args.input:
        vectors = load_float32_matrix(args.input, args.n, args.dim)
    else:
        vectors = rng.random((args.n, args.dim), dtype=np.float32)

    if args.graph and os.path.exists(args.graph):
        graph = load_int_matrix(args.graph, args.n, args.m)
    else:
        t0 = time.perf_counter()
        graph = build_graph(vectors, args.m, seed=args.seed, device=device)
        print(f"Graph build time: {time.perf_counter() - t0:.2f}s")
        if args.graph:
            save_int_matrix(args.graph, graph)

    if args.query:
        queries = load_float32_matrix(args.query, args.q, args.dim)
    else:
        queries = rng.random((args.q, args.dim), dtype=np.float32)

    engine = PlaintextEngine(vectors, graph, device=device)
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    t0 = time.perf_counter()
    ids, _ = engine.search(queries, args.k, args.step, args.parallel,
                           seed=args.seed)
    search_t = time.perf_counter() - t0
    print(f"Search time: {search_t:.3f}s "
          f"({search_t / max(args.q, 1) * 1000:.2f} ms/query)")

    if args.output:
        save_int_matrix(args.output, ids)

    if args.gnd:
        gnd = load_int_matrix(args.gnd, args.q, args.k)
    else:
        gnd = brute_force_knn(vectors, queries, args.k, device=engine.device)
    recall = compute_recall(gnd, ids, args.k)
    print(f"Recall@{args.k}: {recall:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
