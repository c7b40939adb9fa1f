"""What the search over a built graph should find, and the graph's own
contract, worked out in plain torch and numpy.

  graph_rows_wrong  the rows of a graph that break build_graph's contract
                    (the reference's build_graph.go:457-475): every row
                    holds exactly m distinct ids in [0, n), none its own;
  ground_truth      the exact k nearest vectors of each query by brute
                    force, equal distances to the lower id. On integer
                    vectors each distance is an integer below 2^53, exact
                    in float64 in any order of summation;
  recall            recall@k as ComputeRecall counts it (build_graph.go:
                    809-851): each distinct answer id once, scored where
                    the ground truth's k hold it.
"""

from __future__ import annotations

import numpy as np
import torch

# queries a block of the brute-force scan
Q_BLOCK = 64


def graph_rows_wrong(graph: torch.Tensor, n: int, m: int) -> int:
    """How many of the n rows of `graph` (ids, any integer dtype) break
    the contract; every row where the shape is not (n, m)."""
    if tuple(graph.shape) != (n, m):
        return n
    g = graph.long()
    own = torch.arange(n, device=g.device)[:, None]
    srt = torch.sort(g, dim=1).values
    bad = ((g < 0) | (g >= n) | (g == own)).any(dim=1)
    bad |= (srt[:, 1:] == srt[:, :-1]).any(dim=1)
    return int(bad.sum())


def ground_truth(vectors: torch.Tensor, queries: torch.Tensor,
                 k: int) -> torch.Tensor:
    """vectors (n, d) and queries (Q, d), integer-valued, on one device
    -> (Q, k) int64 ids of the k nearest, nearest first, equal distances
    by the lower id."""
    n = vectors.shape[0]
    shift = max(1, (n - 1).bit_length())
    v = vectors.double()
    vn = (v * v).sum(dim=1)
    ids = torch.arange(n, device=v.device)
    out = []
    for q0 in range(0, queries.shape[0], Q_BLOCK):
        q = queries[q0:q0 + Q_BLOCK].to(v.device).double()
        dist = (q * q).sum(dim=1)[:, None] + vn[None, :] - 2.0 * (q @ v.T)
        key = (dist.long() << shift) | ids
        out.append(torch.topk(key, k, dim=1, largest=False).values
                   & ((1 << shift) - 1))
    return torch.cat(out)


def recall(gnd: np.ndarray, answers: np.ndarray, k: int) -> float:
    """Mean over queries of |set(answers[:k]) & set(gnd[:k])| / k."""
    gnd, answers = np.asarray(gnd)[:, :k], np.asarray(answers)[:, :k]
    hits = sum(len(set(a.tolist()) & set(g.tolist()))
               for a, g in zip(answers, gnd))
    return hits / (len(answers) * k) if len(answers) else 0.0
