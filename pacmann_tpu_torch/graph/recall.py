"""Recall / graph-quality evaluation, the port of the JAX package's
graph/recall.py.

Ports of ComputeRecall (the reference's graphann/build_graph.go:809-851,
duplicate-aware recall@k) and EvaluateGraphQuality (:764-805, 100 self-queries
reporting hit rate + average steps-to-reach), and the exact k-NN scan that
gives the ground truth: distances through l2_distance (kernel K6 on CUDA)
and the top-k selection stay on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from pacmann_tpu_torch.graph.beam import PlaintextEngine
from pacmann_tpu_torch.graph.beam_host import BasicGraphOracle, BeamSearcher
from pacmann_tpu_torch.ops.distance import l2_distance
from pacmann_tpu_torch.utils import cuda_lib
from pacmann_tpu_torch.utils.u32 import smallest_k_keyed


def compute_recall(gnd: np.ndarray, response: np.ndarray, k: int) -> float:
    """Duplicate-aware recall@k against top-k ground truth.

    The reference counts each *distinct* response id at most once and scores
    it iff it appears in the top-k ground truth — i.e. per query the hit
    count is |set(response[:k]) ∩ set(gnd[:k])|.
    """
    gnd = np.asarray(gnd)[:, :k]
    response = np.asarray(response)[:, :k]
    num_q = response.shape[0]
    total = 0.0
    for i in range(num_q):
        total += len(set(response[i].tolist()) & set(gnd[i].tolist()))
    return float(total / (num_q * float(k)))


# queries per block of the exact k-NN scan
Q_BLOCK = 1024


def knn_search(vectors: torch.Tensor, queries: torch.Tensor, k: int, *,
               p_block: int = 65536, use_pallas: bool | None = None):
    """Exact k nearest points of each query -> (dist (Q, k) f32, ids (Q, k)
    int64) on the vectors' device, ascending, equal distances by the lower
    id: the order of lax.top_k over each whole row. vectors (n, D) and
    queries (Q, D) are f32 tensors on one device; distances go through
    l2_distance (use_pallas as there) a (Q_BLOCK, p_block) tile at a time,
    and each tile's k best merge into the running k best."""
    k = min(k, vectors.shape[0])
    out_d, out_i = [], []
    for q0 in range(0, queries.shape[0], Q_BLOCK):
        q = queries[q0:q0 + Q_BLOCK]
        best = None
        for b0 in range(0, vectors.shape[0], p_block):
            d = l2_distance(q, vectors[b0:b0 + p_block], use_pallas=use_pallas)
            ids = torch.arange(b0, b0 + d.shape[1], device=d.device)
            d, ids = smallest_k_keyed(d, ids, min(k, d.shape[1]))
            if best is not None:
                d, ids = smallest_k_keyed(torch.cat([best[0], d], dim=1),
                                          torch.cat([best[1], ids], dim=1), k)
            best = (d, ids)
        out_d.append(best[0])
        out_i.append(best[1])
    return torch.cat(out_d), torch.cat(out_i)


def brute_force_knn(vectors, queries, k: int, block: int = 65536,
                    device=None) -> np.ndarray:
    """Exact ground-truth top-k ids, (Q, k) int64 numpy, by blocked L2 scan
    (knn_search). vectors and queries live on `device`; None means a
    tensor's own device and CUDA for a numpy array (which raises where CUDA
    is not available)."""
    dev = cuda_lib.default_device(vectors, device)
    v = torch.as_tensor(vectors, dtype=torch.float32, device=dev)
    q = torch.as_tensor(queries, dtype=torch.float32, device=dev)
    return knn_search(v, q, k, p_block=block)[1].cpu().numpy()


def _numpy(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def evaluate_graph_quality(vectors, graph, num_queries: int = 100,
                           seed: int = 0, use_engine: bool = True,
                           search_fn=None, device=None):
    """Self-query probe: search for each target's own vector; report hit rate
    and average steps (build_graph.go:764-805: k=20, maxStep=20, parallel=2).

    use_engine: the batched PlaintextEngine on `device` (as there: None
    means CUDA for numpy vectors), else the host BeamSearcher.

    search_fn(vectors, graph, start_ids, queries, seed) -> (ids, steps):
    a search the caller brings (the graph build's gate does), given f32
    vectors, int32 graph, the start ids arange(int(sqrt(n))) and f32
    queries as tensors on `device`, and the seed in place of the JAX
    hook's PRNG key."""
    rng = np.random.default_rng(seed)
    n = vectors.shape[0]
    targets = rng.integers(0, n, size=num_queries)
    # index FIRST, then pull the small (Q, d) slice to the host
    if isinstance(vectors, torch.Tensor):
        queries = vectors[torch.as_tensor(targets)].cpu().numpy()
    else:
        queries = np.asarray(vectors[targets])

    if search_fn is not None:
        dev = cuda_lib.default_device(vectors, device)
        ids, steps = search_fn(
            torch.as_tensor(vectors, dtype=torch.float32, device=dev),
            torch.as_tensor(np.asarray(_numpy(graph), np.int32), device=dev),
            torch.arange(int(np.sqrt(n)), device=dev),
            torch.as_tensor(queries, dtype=torch.float32, device=dev), seed)
        ids, steps = _numpy(ids), _numpy(steps)
    elif use_engine:
        engine = PlaintextEngine(vectors, graph, device=device)
        ids, steps = engine.search(queries, k=20, max_step=20, parallel=2,
                                   seed=seed)
    else:
        searcher = BeamSearcher(
            BasicGraphOracle(_numpy(vectors), _numpy(graph)), rng)
        searcher.preprocess()
        ids, steps = searcher.search_knn_batch(queries, 20, 20, 2)

    hits = ids[:, 0] == targets
    hit_rate = float(np.mean(hits))
    avg_steps = float(np.mean(steps[hits, 0])) if np.any(hits) else float("nan")
    return hit_rate, avg_steps
