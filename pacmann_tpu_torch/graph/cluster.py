"""Cluster-search baseline (Tiptoe-style), the port of the JAX package's
graph/cluster.py.

Quality lower-bound baseline, the role of the reference's cluster-search.py
(C16): k-means the DB into ~sqrt(n) clusters (cluster-search.py:86-114,
FAISS), answer a query by brute-force scan of its nearest cluster
(:170-198), report recall (:207-217). Distances to the seeding sample,
to the centroids in the Lloyd assignment and in the query routing go
through ops/distance.py::l2_distance, kernel K6 on CUDA; the per-cluster
sums are blocked one-hot matmuls (deterministic, unlike float atomics);
the in-cluster scan is the direct (v - q)^2 form.

The JAX package seeds k-means++ with jax.random draws, which torch cannot
reproduce: kmeans takes the seeding ids in (`init_ids`), else draws them
from CPU torch.Generators seeded with `seed`.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from pacmann_tpu_torch.graph.build import _lloyd_sums
from pacmann_tpu_torch.ops.distance import l2_distance
from pacmann_tpu_torch.utils import cuda_lib
from pacmann_tpu_torch.utils.u32 import smallest_k

# points of the seeding subsample at most (cluster-search.py's FAISS
# sample role)
SEED_SAMPLE = 65536


def _kmeanspp_init(sample: torch.Tensor, n_clusters: int, *, init_ids=None,
                   seed: int = 0) -> torch.Tensor:
    """k-means++ seeding: the first center uniform, each next one
    D^2-proportionally from the running min-distance -> (n_clusters,) ids
    into `sample`, one l2_distance a center.

    init_ids: the ids to take (the JAX package's, drawn with its PRNG),
    each still costing its distance pass; else the first from a CPU
    torch.Generator seeded with `seed`, the next by inverting the
    cumulative min-distance at a uniform draw of the same generator."""
    n = sample.shape[0]
    dev = sample.device
    gen = torch.Generator().manual_seed(seed)
    if init_ids is not None:
        ids = [int(i) for i in np.asarray(init_ids)]
    else:
        ids = [int(torch.randint(0, n, (), generator=gen))]
    min_d = l2_distance(sample[ids[0]][None, :], sample)[0]
    for i in range(1, n_clusters):
        if init_ids is None:
            u = float(torch.rand((), generator=gen, dtype=torch.float64))
            cum = torch.cumsum(min_d.double(), 0)
            nxt = int(torch.searchsorted(cum, u * float(cum[-1]), right=True))
            ids.append(min(nxt, n - 1))
        d_new = l2_distance(sample[ids[i]][None, :], sample)[0]
        min_d = torch.minimum(min_d, d_new)
    return torch.tensor(ids, dtype=torch.int64, device=dev)


def kmeans(vectors, n_clusters: int, n_iter: int = 10, seed: int = 0,
           block: int = 65536, verbose: bool = False, init_ids=None,
           device=None):
    """k-means++-seeded Lloyd iterations -> (centroids (K, d) f32, labels
    (n,) int32), numpy.

    Seeding runs on a subsample of at most SEED_SAMPLE points, drawn by
    np.random.default_rng(seed).choice in the JAX package's order (init_ids
    index that subsample). Each iteration assigns every block of `block`
    vectors to its nearest centroid (l2_distance, then the first argmin),
    then moves each centroid with members to their mean; an empty cluster
    keeps its centroid. The labels are the last iteration's assignment,
    made before its update, as the JAX package returns them. vectors live
    on `device`: None means a tensor's own device, else the card."""
    dev = cuda_lib.default_device(vectors, device)
    rng = np.random.default_rng(seed)
    if isinstance(vectors, torch.Tensor):
        v = vectors.to(device=dev, dtype=torch.float32)
    else:
        v = torch.from_numpy(np.asarray(vectors, np.float32)).to(dev)
    n = v.shape[0]
    n_sub = min(n, SEED_SAMPLE)
    sub = v if n_sub == n else v[torch.from_numpy(
        rng.choice(n, n_sub, replace=False)).to(dev)]
    with cuda_lib.fp32_matmul(dev):
        centroids = sub[_kmeanspp_init(sub, n_clusters, init_ids=init_ids,
                                       seed=seed)]
        labels = torch.empty(n, dtype=torch.int64, device=dev)
        for it in range(n_iter):
            for b0 in range(0, n, block):
                labels[b0:b0 + block] = torch.argmin(
                    l2_distance(v[b0:b0 + block], centroids), dim=1)
            sums, counts = _lloyd_sums(v, labels, K=n_clusters, block=block)
            new_c = sums / torch.clamp(counts, min=1.0)[:, None]
            # keep empty clusters where they were
            centroids = torch.where(counts[:, None] > 0, new_c, centroids)
            if verbose:
                print(f"kmeans iter {it} done")
    return (centroids.cpu().numpy(),
            labels.to(torch.int32).cpu().numpy())


def _cluster_scan_device(vectors, centroids, members, queries, *, k: int):
    """Route each query to its nearest centroid (l2_distance, first argmin)
    and brute-force its cluster in the direct (v - q)^2 form -> (Qb, k)
    ids, ascending, equal distances by the lower member slot, -1 past the
    cluster's size. members: (K, cap) ids, -1 padded."""
    nearest = torch.argmin(l2_distance(queries, centroids), dim=1)
    mem = members[nearest]                               # (Qb, cap)
    valid = mem >= 0
    vecs = vectors[torch.where(valid, mem, 0)]           # (Qb, cap, d)
    d2 = ((vecs - queries[:, None, :]) ** 2).sum(dim=-1)
    d2 = torch.where(valid, d2, float("inf"))
    d, idx = smallest_k(d2, k)
    ids = torch.gather(mem, 1, idx)
    return torch.where(d < float("inf"), ids, -1)


class ClusterSearcher:
    """Nearest-centroid + in-cluster brute force (cluster-search.py:170-198)."""

    QUERY_BLOCK = 64

    def __init__(self, vectors, n_clusters: int | None = None,
                 n_iter: int = 10, seed: int = 0, verbose: bool = False,
                 init_ids=None, device=None):
        """vectors (n, d) live on `device` (None: a tensor's own device,
        else the card); init_ids as kmeans's."""
        self.device = cuda_lib.default_device(vectors, device)
        self.vectors = np.asarray(
            vectors.cpu() if isinstance(vectors, torch.Tensor) else vectors,
            np.float32)
        n = self.vectors.shape[0]
        if n_clusters is None:
            n_clusters = max(int(np.sqrt(n)), 1)  # cluster-search.py:92
        self._vectors_dev = torch.from_numpy(self.vectors).to(self.device)
        t0 = time.perf_counter()
        self.centroids, self.labels = kmeans(
            self._vectors_dev, n_clusters, n_iter, seed, verbose=verbose,
            init_ids=init_ids)
        self.train_time = time.perf_counter() - t0
        # bucket members per cluster
        order = np.argsort(self.labels, kind="stable")
        self.sorted_ids = order.astype(np.int64)
        self.starts = np.searchsorted(self.labels[order], np.arange(n_clusters))
        self.ends = np.searchsorted(self.labels[order],
                                    np.arange(n_clusters) + 1)
        # fixed-capacity member matrix: every cluster padded to the max size
        sizes = self.ends - self.starts
        cap = max(int(sizes.max()), 1)
        members = np.full((n_clusters, cap), -1, np.int64)
        for c in range(n_clusters):
            members[c, : sizes[c]] = self.sorted_ids[
                self.starts[c] : self.ends[c]]
        self._members_dev = torch.from_numpy(members).to(self.device)
        self._centroids_dev = torch.from_numpy(self.centroids).to(self.device)

    def search(self, queries, k: int) -> np.ndarray:
        """-> ids (Q, k) int64; -1 padded for undersized clusters. Blocks of
        QUERY_BLOCK queries on the device, one routing l2_distance each."""
        queries = torch.as_tensor(np.asarray(queries, np.float32),
                                  device=self.device)
        Q = queries.shape[0]
        out = np.empty((Q, k), np.int64)
        with cuda_lib.fp32_matmul(self.device):
            for b0 in range(0, Q, self.QUERY_BLOCK):
                ids = _cluster_scan_device(
                    self._vectors_dev, self._centroids_dev,
                    self._members_dev, queries[b0:b0 + self.QUERY_BLOCK],
                    k=k)
                out[b0:b0 + self.QUERY_BLOCK] = ids.cpu().numpy()
        return out
