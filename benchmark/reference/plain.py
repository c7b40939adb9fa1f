"""The plaintext beam search of a batch of queries (graphann/search.go:
114-234, the search graphann/cmd/ann/ann.go runs over vectors and graph
held in the clear), worked out step by step in plain torch.

A query's visited table has parallel + steps * parallel * m slots. It
starts with the `parallel` start vertices nearest to the query, unexplored;
step g writes the parallel * m slots from parallel + g * parallel * m on.
Each step, for each query on its own:
  1. pops the `parallel` nearest unexplored slots (equal distances: the
     earlier slot first) and marks them explored; a pop that finds none
     takes its m padding ids of the step in place of a vertex's neighbours;
  2. takes the m neighbours of each pop, clipped to [0, n): parallel * m
     candidates;
  3. accepts a candidate that the query's table does not hold yet, that is
     the first copy among the step's candidates, and whose own neighbour
     row is not all zero (a failed fetch, search.go:192-199);
  4. writes each accepted candidate, its distance and its neighbour row into
     the step's slots, unexplored; a rejected candidate's slot stays empty.
The answer is the k nearest ids of the table (equal distances: the earlier
slot first), -1 where it holds fewer than k. On u8-valued vectors every
squared distance is an integer below 2^24, exact in float32 whatever the
order of summation, so equal inputs give equal answers.
"""

from __future__ import annotations

import torch

from reference.search import first_in_row, nearest

INF = float("inf")
# queries a block: each query searches on its own
Q_BLOCK = 256


def beam_search(vectors, graph, start_ids, queries, rand_ids, *, k, steps,
                parallel):
    """vectors (n, d) float32 and graph (n, m) ids, on the queries' device;
    start_ids (Ns,); queries (Q, d) float32; rand_ids (Q, steps, parallel,
    m) padding ids. -> (Q, k) int64 answers, -1 padded."""
    dev = queries.device
    vectors, graph = vectors.to(dev), graph.to(dev).long()
    start_ids, rand_ids = start_ids.to(dev).long(), rand_ids.to(dev).long()
    return torch.cat([
        _search(vectors, graph, start_ids, queries[q0:q0 + Q_BLOCK],
                rand_ids[q0:q0 + Q_BLOCK], k=k, steps=steps,
                parallel=parallel)
        for q0 in range(0, queries.shape[0], Q_BLOCK)])


def _search(vectors, graph, start_ids, queries, rand_ids, *, k, steps,
            parallel):
    dev = queries.device
    n, m = graph.shape
    Qn = queries.shape[0]
    pm = parallel * m
    cap = parallel + steps * pm
    rows = torch.arange(Qn, device=dev)
    ids = torch.full((Qn, cap), -1, dtype=torch.int64, device=dev)
    dist = torch.full((Qn, cap), INF, dtype=torch.float32, device=dev)
    nbrs = torch.zeros((Qn, cap, m), dtype=torch.int64, device=dev)
    explored = torch.ones((Qn, cap), dtype=torch.bool, device=dev)
    sd = ((vectors[start_ids][None, :, :] - queries[:, None, :]) ** 2).sum(-1)
    d0, s0 = nearest(sd, parallel)
    ids[:, :parallel] = start_ids[s0]
    dist[:, :parallel] = d0
    nbrs[:, :parallel] = graph[start_ids[s0]]
    explored[:, :parallel] = False

    for g in range(steps):
        # 1. pop
        d, slots = nearest(torch.where(explored, INF, dist), parallel)
        valid = d < INF
        slots = torch.where(valid, slots, 0)
        explored[rows[:, None].expand(-1, parallel)[valid], slots[valid]] \
            = True
        # 2. candidates
        cand = torch.where(valid[:, :, None], nbrs[rows[:, None], slots],
                           rand_ids[:, g])
        cand = cand.clamp(0, n - 1).reshape(Qn, pm)
        # 3. accepted
        known = torch.isin(rows[:, None] * n + cand,
                           (rows[:, None] * n + ids)[ids >= 0])
        row = graph[cand]
        take = ~known & first_in_row(cand) & (row != 0).any(dim=2)
        # 4. the step's slots
        cd = ((vectors[cand] - queries[:, None, :]) ** 2).sum(-1)
        w = slice(parallel + g * pm, parallel + (g + 1) * pm)
        ids[:, w] = torch.where(take, cand, -1)
        dist[:, w] = torch.where(take, cd, INF)
        nbrs[:, w] = torch.where(take[:, :, None], row, 0)
        explored[:, w] = ~take

    d, slot = nearest(dist, k)
    return torch.where(d < INF, torch.gather(ids, 1, slot), -1)
