"""Batched plaintext beam search, the port of the JAX package's graph/beam.py.

Fixed-shape state per query, the reference's best-first semantics
(graphann/search.go:114-234):

  * visited table: parallel + max_step*parallel*m slots; step s writes its
    parallel*m fetched candidates into the window starting at
    parallel + s*parallel*m, rejected ones as id -1 / dist +inf;
  * frontier pop: the `parallel` smallest unexplored slots (the heap's
    extract-min), equal distances in ascending slot order;
  * dedup: a candidate already in the query's visited table, or an earlier
    copy in the same step, is rejected (the knownVertices map);
  * an empty frontier, or benchmarking, takes random ids instead
    (search.go:155-159), keeping the access pattern fixed;
  * candidates whose neighbour row is all zero are skipped (failed PIR
    fetches, search.go:192-199).

The JAX package runs the steps as a lax.scan vmapped over queries; here one
Python loop over steps drives torch ops batched over the queries on the
vectors' device. The per-step distances (each query against its own
candidates) are plain torch in the reference's formula, as the JAX package
computes them outside any Pallas kernel.

The JAX package draws each step's random ids from its PRNG, which torch
cannot reproduce: search() and search_paths_all() take them as
`step_randoms`, or draw them with a torch.Generator on the device.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from pacmann_tpu_torch.ops.distance import l2_distance_plain
from pacmann_tpu_torch.utils import cuda_lib, trace
from pacmann_tpu_torch.utils.u32 import smallest_k

INF = float("inf")


def first_occurrence(ids: torch.Tensor) -> torch.Tensor:
    """(Qn, B) -> (Qn, B) bool: True where no earlier column holds the id."""
    B = ids.shape[1]
    eq = ids[:, :, None] == ids[:, None, :]
    lower = torch.ones((B, B), dtype=torch.bool, device=ids.device).tril(-1)
    return ~(eq & lower).any(dim=2)


def finish_topk(ids, dist, *, topk, parallel, m):
    """Top-k of the visited table -> (ids, reach_steps). Slots [0, parallel)
    hold the seeds (step 0) and step g writes the window starting at
    parallel + g*parallel*m, so a slot's step is
    (slot - parallel) // (parallel*m)."""
    d, slot = smallest_k(dist, topk)
    valid = d < INF
    out = torch.where(valid, torch.gather(ids, 1, slot), -1)
    steps = torch.div((slot - parallel).clamp(min=0), parallel * m,
                      rounding_mode="floor")
    steps = torch.where(valid, steps, -1)
    return out, steps


def pop_frontier(dist: torch.Tensor, explored: torch.Tensor, parallel: int):
    """A beam step's frontier pop for every query: the `parallel` smallest
    unexplored slots (the heap's extract-min), equal distances in ascending
    slot order -> (slots, valid), (Qn, parallel); an empty pop is invalid
    and gives slot 0. Marks the valid pops explored in place: invalid pops
    alias slot 0, so only the real pops are OR-ed in (the reference's
    scatter-max)."""
    d, slots = smallest_k(torch.where(explored, INF, dist), parallel)
    valid = d < INF
    slots = torch.where(valid, slots, 0)
    cap = dist.shape[1]
    explored |= ((torch.arange(cap, device=dist.device) == slots[:, :, None])
                 & valid[:, :, None]).any(dim=1)
    return slots, valid


def _l2_own(queries: torch.Tensor, vecs: torch.Tensor) -> torch.Tensor:
    """(Q, d) queries x (Q, B, d) candidates, each query against its own:
    (Q, B) squared L2 in l2_distance_xla's formula, max((qn + pn) - 2 q.p,
    0), with exact fp32 products."""
    qn = (queries * queries).sum(dim=-1, keepdim=True)
    pn = (vecs * vecs).sum(dim=-1)
    cross = (vecs * queries[:, None, :]).sum(dim=-1)
    return (qn + pn - 2.0 * cross).clamp_(min=0.0)


def _seed(queries, start_ids, start_vecs, start_nbrs, *, parallel, cap, m,
          benchmarking):
    """Visited tables (ids, dist, nbrs, explored) holding each query's
    `parallel` nearest start vertices (search.go:129-148); benchmarking
    leaves them empty."""
    Q = queries.shape[0]
    dev = queries.device
    ids = torch.full((Q, cap), -1, dtype=torch.int32, device=dev)
    dist = torch.full((Q, cap), INF, dtype=torch.float32, device=dev)
    nbrs = torch.zeros((Q, cap, m), dtype=torch.int32, device=dev)
    explored = torch.ones((Q, cap), dtype=torch.bool, device=dev)
    if not benchmarking:
        d, sidx = smallest_k(l2_distance_plain(queries, start_vecs), parallel)
        ids[:, :parallel] = start_ids[sidx]
        dist[:, :parallel] = d
        nbrs[:, :parallel] = start_nbrs[sidx]
        explored[:, :parallel] = False
    return ids, dist, nbrs, explored


def _step(beam, queries, vectors, graph, rand_ids, step_idx, *, n, m,
          parallel, benchmarking):
    """One beam step for every query: pop, fetch, dedup, write the step's
    window of the visited tables in place. rand_ids (Q, parallel, m).
    Returns the popped (expanded) ids, (Q, parallel), -1 for empty pops."""
    ids, dist, nbrs, explored = beam
    Q = ids.shape[0]
    B = parallel * m
    q_ix = torch.arange(Q, device=ids.device)[:, None]

    slots, valid = pop_frontier(dist, explored, parallel)
    popped = torch.where(valid, ids[q_ix, slots], -1)
    if benchmarking:
        return popped

    batch = torch.where(valid[:, :, None], nbrs[q_ix, slots], rand_ids)
    batch = batch.reshape(Q, B).clamp(0, n - 1)
    vecs, cand = vectors[batch], graph[batch]
    cdist = _l2_own(queries, vecs)
    base = parallel + step_idx * B
    # slots from base on are still empty (-1), which no clipped id matches
    known = (batch[:, :, None] == ids[:, None, :base]).any(dim=2)
    accept = ~known & first_occurrence(batch) & (cand != 0).any(dim=2)

    w = slice(base, base + B)
    ids[:, w] = torch.where(accept, batch, -1)
    dist[:, w] = torch.where(accept, cdist, INF)
    nbrs[:, w] = torch.where(accept[:, :, None], cand, 0)
    explored[:, w] = ~accept
    return popped


def _untraced(name: str):
    return contextlib.nullcontext()


def _beam_search(vectors, graph, start_ids, queries, rand, *, n, m,
                 max_step, parallel, benchmarking=False, traced=False):
    """All steps for a batch of queries. rand (Q, max_step, parallel, m).
    Returns the visited tables and the popped ids (Q, max_step, parallel).
    traced: the seed is span "ann.seed" of the port's tracing and each step
    a span "ann.step" (counter "ann.steps"), as PlaintextEngine.search
    runs them; search_paths_all opens none."""
    span = trace.span if traced else _untraced
    cap = parallel + max_step * parallel * m
    with span("ann.seed"):
        beam = _seed(queries, start_ids, vectors[start_ids],
                     graph[start_ids], parallel=parallel, cap=cap, m=m,
                     benchmarking=benchmarking)
    popped = []
    for s in range(max_step):
        with span("ann.step"):
            if traced:
                trace.count("ann.steps")
            popped.append(_step(beam, queries, vectors, graph, rand[:, s], s,
                                n=n, m=m, parallel=parallel,
                                benchmarking=benchmarking))
    return beam, torch.stack(popped, dim=1)


def _as_randoms(step_randoms, device) -> torch.Tensor:
    if isinstance(step_randoms, torch.Tensor):
        return step_randoms.to(device=device, dtype=torch.int32)
    return torch.from_numpy(np.asarray(step_randoms).astype(np.int32)).to(
        device)


def search_paths_all(vectors: torch.Tensor, graph: torch.Tensor,
                     start_ids: torch.Tensor, step_randoms=None, *, n: int,
                     m: int, max_step: int, parallel: int, block: int,
                     seed: int = 0) -> torch.Tensor:
    """Expansion corridors for EVERY vertex: search each vertex's own vector
    over `graph` and return the ids of the vertices popped (expanded) along
    the way -> (npad, max_step*parallel) int32 on the vectors' device, -1
    where the frontier was empty. Vertices go `block` at a time.

    step_randoms: (npad, max_step, parallel, m) ids, row i for vertex i
    (the JAX package's draw for row j of block b is keyed by
    fold_in(key, b)), or a function of (r0, r1) giving rows [r0, r1) of
    them, called for the blocks in row order; None draws each block's
    from a torch.Generator seeded with `seed`."""
    npad = vectors.shape[0]
    dev = vectors.device
    if step_randoms is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(seed)

        def step_randoms(r0, r1):
            return torch.randint(0, n, (r1 - r0, max_step, parallel, m),
                                 generator=generator, dtype=torch.int32,
                                 device=dev)
    elif not callable(step_randoms):
        whole = _as_randoms(step_randoms, dev)

        def step_randoms(r0, r1):
            return whole[r0:r1]
    paths = []
    for r0 in range(0, npad, block):
        r1 = min(r0 + block, npad)
        rand = _as_randoms(step_randoms(r0, r1), dev)
        _, popped = _beam_search(vectors, graph, start_ids, vectors[r0:r1],
                                 rand, n=n, m=m, max_step=max_step,
                                 parallel=parallel)
        paths.append(popped.reshape(r1 - r0, max_step * parallel))
    return torch.cat(paths)


class PlaintextEngine:
    """Batched plaintext k-NN search over device-resident vectors + graph."""

    def __init__(self, vectors, graph, start_ids=None, device=None):
        """vectors (n, d), graph (n, m): numpy arrays or tensors. They live
        on `device`; None means a tensor's own device and CUDA for a numpy
        array (which raises where CUDA is not available)."""
        self.device = cuda_lib.default_device(vectors, device)
        self.vectors = torch.as_tensor(vectors, dtype=torch.float32,
                                       device=self.device)
        self.graph = torch.as_tensor(graph, dtype=torch.int32,
                                     device=self.device)
        n = self.vectors.shape[0]
        if start_ids is None:
            start_ids = np.arange(int(np.sqrt(n)))  # search.go:51-65
        self.start_ids = torch.as_tensor(start_ids, dtype=torch.int64,
                                         device=self.device)

    def search(self, queries, k, max_step, parallel, seed=0,
               benchmarking=False, step_randoms=None, traced=True):
        """-> (ids, reach_steps), (Q, k) int32 numpy arrays, -1 padded.

        step_randoms: (Q, max_step, parallel, m) random ids in [0, n), the
        JAX package's split(split(PRNGKey(seed), Q)[i], max_step)[s] draws;
        None draws them from a torch.Generator seeded with `seed`.

        traced: the search is a request "ann" of the port's tracing
        (utils/trace.py; counter "ann.queries"): "ann.seed", an "ann.step"
        a step (counter "ann.steps") and "ann.finish", the top-k and the
        copies to the host. The graph build's quality gate passes False, so
        that a traced build records its own spans alone."""
        span = trace.span if traced else _untraced
        with span("ann"):
            n, m = self.graph.shape
            q = torch.as_tensor(queries, dtype=torch.float32,
                                device=self.device)
            if traced:
                trace.count("ann.queries", q.shape[0])
            if step_randoms is None:
                gen = torch.Generator(device=self.device)
                gen.manual_seed(seed)
                rand = torch.randint(0, n, (q.shape[0], max_step, parallel,
                                            m), generator=gen,
                                     dtype=torch.int32, device=self.device)
            else:
                rand = _as_randoms(step_randoms, self.device)
            (ids, dist, _, _), _ = _beam_search(
                self.vectors, self.graph, self.start_ids, q, rand, n=n, m=m,
                max_step=max_step, parallel=parallel,
                benchmarking=benchmarking, traced=traced)
            with span("ann.finish"):
                out, steps = finish_topk(ids, dist, topk=k,
                                         parallel=parallel, m=m)
                return out.cpu().numpy(), steps.to(torch.int32).cpu().numpy()
