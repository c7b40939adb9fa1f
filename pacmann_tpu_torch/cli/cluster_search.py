"""Cluster-search baseline command, the port of the JAX package's
cli/cluster_search.py (the reference's cluster-search.py driver): k-means
the DB, search each query's nearest cluster, report recall against the
exact k-NN (brute_force_knn, kernel K6 on CUDA)."""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from pacmann_tpu_torch.graph.cluster import ClusterSearcher
from pacmann_tpu_torch.graph.recall import brute_force_knn, compute_recall
from pacmann_tpu_torch.io.loaders import load_float32_matrix, load_int_matrix


def main(argv=None, device=None) -> int:
    """device: where k-means, the search and the ground truth run (a Python
    keyword, not a flag); None means CUDA, which raises where CUDA is not
    available."""
    p = argparse.ArgumentParser(prog="pacmann-cluster-search")
    p.add_argument("-n", type=int, default=10000)
    p.add_argument("-d", "--dim", type=int, default=128)
    p.add_argument("-k", type=int, default=10)
    p.add_argument("-q", type=int, default=100)
    p.add_argument("-input", default="")
    p.add_argument("-query", default="")
    p.add_argument("-gnd", default="")
    p.add_argument("-clusters", type=int, default=0, help="0 = sqrt(n)")
    p.add_argument("-iters", type=int, default=10)
    p.add_argument("-report", default="")
    p.add_argument("-seed", type=int, default=0)
    args = p.parse_args(argv)

    rng = np.random.default_rng(args.seed)
    if args.input:
        vectors = load_float32_matrix(args.input, args.n, args.dim)
    else:
        vectors = rng.random((args.n, args.dim), dtype=np.float32)
    if args.query:
        queries = load_float32_matrix(args.query, args.q, args.dim)
    else:
        queries = rng.random((args.q, args.dim), dtype=np.float32)

    searcher = ClusterSearcher(
        vectors, args.clusters or None, args.iters, args.seed, device=device)
    print(f"k-means train time: {searcher.train_time:.2f}s")

    if searcher.device.type == "cuda":
        torch.cuda.synchronize(searcher.device)
    t0 = time.perf_counter()
    ids = searcher.search(queries, args.k)
    per_q = (time.perf_counter() - t0) / max(args.q, 1)
    print(f"Avg query time: {per_q*1000:.3f} ms")

    if args.gnd:
        gnd = load_int_matrix(args.gnd, args.q, args.k)
    else:
        gnd = brute_force_knn(vectors, queries, args.k,
                              device=searcher.device)
    recall = compute_recall(gnd, ids, args.k)
    print(f"Recall@{args.k}: {recall:.4f}")

    if args.report:
        with open(args.report, "a") as f:
            f.write(f"avg query time (ms): {per_q*1000:.4f}\n")
            f.write(f"recall: {recall:.4f}\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
