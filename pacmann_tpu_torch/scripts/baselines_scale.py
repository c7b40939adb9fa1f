"""Baseline runs at canonical scale on the same synthetic data as
e2e_scale: the port's twin of the JAX package's scripts/baselines_scale.py.
They anchor the comparison table the way the reference's ngt-report.txt /
cluster-report.txt do (C15/C16):

  exact   — blocked K6 scan + keyed top-k (graph/recall.py::knn_search);
            recall 1.0 by construction, the quality upper bound (the role
            NGT's 0.999 plays in the reference)
  cluster — Tiptoe-style k-means (sqrt(n) clusters, 10 iterations) +
            in-cluster scan (graph/cluster.py::ClusterSearcher); the
            quality lower bound (reference: 0.391 on SIFT1M)

Usage: python -m pacmann_tpu_torch.scripts.baselines_scale [--n 1000000]
           [--latent 16] [--continuum] [--queries 100] [--k 10]
           [--device cuda|cpu] [--out DIR]
Writes reports/torch/{exact,cluster}-{tag}-report.txt (--out: another
directory); each names the card and its power limit it ran on.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

from pacmann_tpu_torch.scripts import REPORTS, device_line, sync
from pacmann_tpu_torch.scripts.e2e_scale import synth_continuum, synth_vectors
from pacmann_tpu_torch.utils import cuda_lib


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="baselines_scale",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--latent", type=int, default=16)
    ap.add_argument("--continuum", action="store_true",
                    help="latent-manifold continuum data (the separation "
                         "workload; expect cluster recall to collapse)")
    ap.add_argument("--queries", type=int, default=100)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device of both baselines (default: the "
                         "card)")
    ap.add_argument("--out", default=str(REPORTS),
                    help="directory of the two reports")
    return ap


def main(argv=None) -> dict:
    """Run both baselines; returns their numbers (also written as the two
    report files)."""
    args = build_parser().parse_args(argv)
    dev = cuda_lib.default_device(None, args.device)
    n, d, Q, k = args.n, 128, args.queries, args.k
    kind = "continuum" if args.continuum else "clustered"
    tag = f"{n}_{kind}_l{args.latent}"
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    where = device_line(dev)
    if dev.type == "cuda":
        where = f"one {where.replace(', ', ' at ')} power limit"

    rng = np.random.default_rng(0)
    t0 = time.time()
    if args.continuum:
        vectors = synth_continuum(n, d, rng, latent=args.latent)
    else:
        vectors = synth_vectors(n, d, True, rng, latent=args.latent)
    print(f"vectors: {time.time() - t0:.1f}s", flush=True)
    queries = vectors[rng.choice(n, Q, replace=False)] \
        + 0.1 * rng.standard_normal((Q, d)).astype(np.float32)

    from pacmann_tpu_torch.graph.recall import (
        brute_force_knn,
        compute_recall,
        knn_search,
    )

    t0 = time.time()
    gnd = brute_force_knn(vectors, queries, k, device=dev)
    print(f"gnd: {time.time() - t0:.1f}s", flush=True)

    # ---- exact scan (quality upper bound; ngt-search.go role)
    v_dev = torch.from_numpy(vectors).to(dev)
    q_dev = torch.from_numpy(queries).to(dev)
    knn_search(v_dev, q_dev, k)                  # first call: kernel build
    sync(dev)
    t0 = time.perf_counter()
    ids = knn_search(v_dev, q_dev, k)[1].cpu().numpy()
    dt = time.perf_counter() - t0
    rec = compute_recall(gnd, ids, k)
    del v_dev, q_dev
    res = {"exact_recall": rec, "exact_ms_per_query": dt / Q * 1000,
           "device": where}
    lines = [
        "Exact scan baseline, blocked K6 + keyed top-k (quality upper "
        "bound; NGT role, ngt-search.go:68-294)",
        f"n {n} dim {d} k {k} queries {Q} data {kind} latent={args.latent}",
        f"Avg query time: {dt / Q * 1000:.3f} ms "
        f"({n * Q / max(dt, 1e-9) / 1e9:.2f} G dist/s, {where})",
        f"Recall@{k}: {rec:.4f}",
        "(reference NGT on SIFT1M: recall 0.999, 1.03 ms/query)",
    ]
    (out_dir / f"exact-{tag}-report.txt").write_text("\n".join(lines) + "\n")
    print("\n".join(lines), flush=True)

    # ---- cluster baseline (quality lower bound; cluster-search.py role)
    from pacmann_tpu_torch.graph.cluster import ClusterSearcher

    K = int(np.sqrt(n))
    t0 = time.time()
    cs = ClusterSearcher(vectors, n_clusters=K, n_iter=10, seed=0,
                         device=dev)
    sync(dev)
    build_s = time.time() - t0
    cs.search(queries[: cs.QUERY_BLOCK], k)      # first call at the block
    sync(dev)
    t0 = time.perf_counter()
    ids_c = cs.search(queries, k)
    t_query = time.perf_counter() - t0
    rec_c = compute_recall(gnd, ids_c, k)
    res.update(cluster_recall=rec_c, kmeans_s=build_s,
               cluster_ms_per_query=t_query / Q * 1000)
    lines = [
        f"Cluster (Tiptoe-style) baseline: k-means sqrt(n)={K} clusters, "
        f"nearest-cluster brute force (cluster-search.py role)",
        f"n {n} dim {d} k {k} queries {Q} data {kind} latent={args.latent}",
        f"k-means build: {build_s:.1f}s ({where})",
        f"Avg query time: {t_query / Q * 1000:.3f} ms",
        f"Recall@{k}: {rec_c:.4f}",
        "(reference FAISS cluster baseline on SIFT1M: recall 0.391, "
        "0.374 ms/query)",
    ]
    (out_dir / f"cluster-{tag}-report.txt").write_text(
        "\n".join(lines) + "\n")
    print("\n".join(lines), flush=True)
    return res


if __name__ == "__main__":
    main()
