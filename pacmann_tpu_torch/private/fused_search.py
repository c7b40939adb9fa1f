"""Fused private search in PyTorch: beam traversal + the PianoPIR online
protocol per step, the port of the JAX package's private/fused_search.py.

Each beam step, over a group of concurrent queries:
  1. frontier pop: the `parallel` best unexplored vertices per query
     (extract-min, graphann/search.go:150-171; ties by lowest slot);
  2. dedup (the reference's response cache, pianopir/pir.go:381-383): an id
     already in its query's visited table is not re-fetched, and only the
     first same-step occurrence of an id goes to PIR;
  3. FCFS routing: surviving ids are ranked within their batch-PIR
     partitions and the first `quota` per partition become sub-queries,
     the rest are dropped (batch-pir.go:194-216);
  4. PIR: the engine's device round (`_round`, _round_on on each shard
     of a sharded engine) serves quota sub-queries per partition on the
     engine's protocol route (on CUDA kernel K3 selects unless a route
     or a table-free engine says otherwise, K4 claims on route "pallas";
     kernel K2 answers; a table-free engine's offsets come from kernel
     K5);
  5. decode (vector || neighbors) and update the visited table
     (search.go:187-207).

The JAX package runs a segment of steps as one compiled program, and above
4 GiB of DB (or with split_route) as a chain of programs a step; here one
Python loop over steps drives torch ops on the engine's device, one form
at every size, and the engine's round hook reaches its DB and state (so
the search runs over the sharded engines too). On a CUDA device steps 1-3
and 5 are CUDA graphs replayed on buffers the search owns (StepGraphs),
and the round (4) is launched eagerly between them. Segments are sized to
the hint budget left, with a refresh between them (pir.go:525-533 lifted
to the group level), exactly as there.

The JAX package draws each step's random padding ids and dummy offsets
from its PRNG, which torch cannot reproduce: search() takes them as
`step_randoms`, or draws them with a torch.Generator on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from pacmann_tpu_torch.graph.beam import (finish_topk, first_occurrence,
                                          pop_frontier)
from pacmann_tpu_torch.pir.device_engine import DevicePianoEngine
from pacmann_tpu_torch.utils import trace
from pacmann_tpu_torch.utils.u32 import as_f32, first_true, smallest_k

INF = float("inf")
# the trace counters of fetch_stats' three columns, counted a search from
# the copy of its stats the search makes anyway
FETCH_COUNTERS = ("search.fetches_wanted", "search.fetches_kept",
                  "search.fetches_served")


def _seed_beam(queries, start_ids, start_vecs, start_nbrs, *, parallel,
               cap, m, out=None):
    """Seed the visited tables from the start set (search.go:129-148).
    Returns the beam (ids, dist, nbrs, explored): `out`, filled whole, if
    given (tensors of those shapes), else new tensors."""
    Qn = queries.shape[0]
    dev = queries.device
    sdist = ((start_vecs[None, :, :] - queries[:, None, :]) ** 2).sum(dim=-1)
    d, sidx = smallest_k(sdist, parallel)                   # (Qn, parallel)
    if out is None:
        out = (torch.empty((Qn, cap), dtype=torch.int32, device=dev),
               torch.empty((Qn, cap), dtype=torch.float32, device=dev),
               torch.empty((Qn, cap, m), dtype=torch.int32, device=dev),
               torch.empty((Qn, cap), dtype=torch.bool, device=dev))
    ids, dist, nbrs, explored = out
    ids.fill_(-1)
    dist.fill_(INF)
    nbrs.zero_()
    explored.fill_(True)
    ids[:, :parallel] = start_ids[sidx]
    dist[:, :parallel] = d
    nbrs[:, :parallel] = start_nbrs[sidx]
    explored[:, :parallel] = False
    return out


def draw_step_randoms(gen: torch.Generator, *, max_step, Qn, parallel, m,
                      n, quota, P, S, C, device, rand_out=None):
    """Every step's random values: rand_ids_all (max_step, Qn, parallel, m)
    int32 in [0, n) — padding for invalid pops — and rnd_all (max_step,
    quota, P, S) int32 in [0, C) — oblivious dummy offsets. The role of the
    JAX package's _draw_step_randoms, with torch's generator. rand_out: a
    tensor of rand_ids_all's shape to draw it into, the same values."""
    rand_ids = torch.randint(0, n, (max_step, Qn, parallel, m),
                             generator=gen, dtype=torch.int32, device=device,
                             out=rand_out)
    rnd = torch.randint(0, C, (max_step, quota, P, S), generator=gen,
                        dtype=torch.int32, device=device)
    return rand_ids, rnd


def _route_core(ids, dist, nbrs, explored, rand_ids, *, psize, m, P,
                parallel, quota, n):
    """Steps 1-3: frontier pop, dedup, FCFS routing. Updates `explored` in
    place; returns (fid (F,), known (Qn, parallel*m), is_first, keep, slot,
    fo_idx, has_first (F,), idx_q (quota, P))."""
    Qn = ids.shape[0]
    F = Qn * parallel * m
    dev = ids.device

    # 1. frontier pop
    slots, valid = pop_frontier(dist, explored, parallel)
    popped = nbrs[torch.arange(Qn, device=dev)[:, None], slots]
    fid = torch.where(valid[:, :, None], popped, rand_ids).reshape(F)
    fid = fid.clamp(0, n - 1)

    # 2. dedup: (a) ids already in this query's visited table, (b) all but
    #    the first same-step copy of a wanted id
    known = (fid.reshape(Qn, parallel * m)[:, :, None]
             == ids[:, None, :]).any(dim=2)                 # (Qn, parallel*m)
    wanted = ~known.reshape(F)
    eqm = (fid[:, None] == fid[None, :]) & wanted[None, :]
    has_first = eqm.any(dim=1)
    fo_idx = first_true(eqm, 1)
    is_first = (fo_idx == torch.arange(F, device=dev)) & wanted

    # 3. partition routing with FCFS quota (batch-pir.go:178-216)
    pa = torch.div(fid, psize, rounding_mode="floor")       # (F,)
    onehot = (pa[:, None] == torch.arange(P, device=dev)) & is_first[:, None]
    rank = torch.gather(torch.cumsum(onehot, dim=0), 1,
                        pa.long()[:, None])[:, 0] - 1
    keep = is_first & (rank < quota)
    slot = torch.where(keep, rank * P + pa, -1)
    match = slot[None, :] == torch.arange(quota * P, device=dev)[:, None]
    src_f = first_true(match, 1)
    local = fid - pa * psize
    idx_q = torch.where(match.any(dim=1), local[src_f], -1).reshape(quota, P)
    return (fid, known, is_first, keep, slot, fo_idx, has_first,
            idx_q.to(torch.int32))


def _pad_round(entries, oks, width, out=None):
    """A round's entries (quota, P, Ep) and oks (quota, P) as rows
    (quota*P + 1, width) of their first `width` words and (quota*P + 1,)
    served flags, the last row zero and unserved: the row that overflow and
    failed firsts read. out: such a pair whose last row is zero, written in
    place; else a new pair."""
    Qp = oks.numel()
    if out is None:
        out = (torch.zeros((Qp + 1, width), dtype=entries.dtype,
                           device=entries.device),
               torch.zeros(Qp + 1, dtype=torch.bool, device=oks.device))
    ent, ok = out
    ent[:Qp].copy_(entries.reshape(Qp, -1)[:, :width])
    ok[:Qp].copy_(oks.reshape(Qp))
    return out


def _update_core(beam, stats, queries, ent, ok, route_out, step_idx, *,
                 dim, m, P, parallel, quota):
    """Step 5: response fan-out, decode, visited-table update and fetch
    accounting, from the round padded by _pad_round (ent, ok). Writes the
    step's window of the beam and `stats` in place."""
    ids, dist, nbrs, explored = beam
    fid, known, is_first, keep, slot, fo_idx, has_first = route_out
    Qn = queries.shape[0]
    dev = ids.device
    # every fetch reads its first occurrence's response slot (overflow and
    # failed firsts resolve to the zero row)
    sfo = torch.where(has_first, slot[fo_idx], -1)
    rslot = torch.where(sfo >= 0, sfo, quota * P)
    res = ent[rslot]                                        # (F, dim + m)
    res_ok = ok[rslot] & keep[fo_idx] & has_first

    vec = as_f32(res[:, :dim])                              # (F, dim)
    nb = res[:, dim:dim + m]                                # (F, m)
    q_of = torch.arange(Qn, device=dev).repeat_interleave(parallel * m)
    cdist = ((vec - queries[q_of]) ** 2).sum(dim=-1)

    pm = parallel * m
    fid_q = fid.reshape(Qn, pm)
    nb_q = nb.reshape(Qn, pm, m)
    d_q = cdist.reshape(Qn, pm)
    ok_q = res_ok.reshape(Qn, pm)
    accept = ~known & first_occurrence(fid_q) & (nb_q != 0).any(dim=2) & ok_q

    # contiguous write window [base, base + parallel*m)
    base = parallel + step_idx * pm
    w = slice(base, base + pm)
    ids[:, w] = torch.where(accept, fid_q, -1)
    dist[:, w] = torch.where(accept, d_q, INF)
    nbrs[:, w] = torch.where(accept[:, :, None], nb_q, 0)
    explored[:, w] = ~accept

    # fetch-success accounting: distinct wanted fetches, quota survivors,
    # PIR-served survivors (the padding row is unserved)
    stats += torch.stack([is_first.sum(), keep.sum(), ok.sum()])


class StepGraphs:
    """The buffers of one step shape of a FusedPrivateSearch, which
    search() writes in place of allocating: the queries, the beam, the
    fetch stats and the steps' padding ids. On a CUDA device each beam
    step's routing (_route_core) and update (_update_core) on them are
    CUDA graphs, captured on first use in the order they replay, all in
    one memory pool; the engine's round runs eagerly between the two, and
    its entries and oks are copied into the update's static inputs."""

    def __init__(self, *, Qn: int, parallel: int, max_step: int, dim: int,
                 m: int, P: int, quota: int, psize: int, n: int, device):
        cap = parallel + max_step * parallel * m
        self.queries = torch.empty((Qn, dim), dtype=torch.float32,
                                   device=device)
        self.beam = (torch.empty((Qn, cap), dtype=torch.int32, device=device),
                     torch.empty((Qn, cap), dtype=torch.float32,
                                 device=device),
                     torch.empty((Qn, cap, m), dtype=torch.int32,
                                 device=device),
                     torch.empty((Qn, cap), dtype=torch.bool, device=device))
        self.stats = torch.zeros(3, dtype=torch.int64, device=device)
        self.rand_all = torch.empty((max_step, Qn, parallel, m),
                                    dtype=torch.int32, device=device)
        self.graphed = torch.device(device).type == "cuda"
        if not self.graphed:
            return
        self.width = dim + m
        self.round_in = (torch.zeros((quota * P + 1, dim + m),
                                     dtype=torch.int32, device=device),
                         torch.zeros(quota * P + 1, dtype=torch.bool,
                                     device=device))
        self.route_kw = dict(psize=psize, m=m, P=P, parallel=parallel,
                             quota=quota, n=n)
        self.update_kw = dict(dim=dim, m=m, P=P, parallel=parallel,
                              quota=quota)
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(device)
        self.routes = [None] * max_step     # (graph, idx_q)
        self.updates = [None] * max_step
        # route outputs an update not yet captured reads, by step
        self.pending = {}
        # one eager step on empty tables (every pop invalid, padding id 0)
        # runs every kernel the graphs hold before the first capture;
        # search() seeds over it
        ids, dist, nbrs, explored = self.beam
        ids.fill_(-1)
        dist.fill_(INF)
        nbrs.zero_()
        explored.fill_(True)
        out = _route_core(*self.beam, self.rand_all[0].zero_(),
                          **self.route_kw)
        _update_core(self.beam, self.stats, self.queries.zero_(),
                     *self.round_in, out[:-1], 0, **self.update_kw)

    def _capture(self, fn):
        """fn's device work captured as a graph in the pool, not run ->
        (graph, fn's result)."""
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(self.stream):
            graph.capture_begin(pool=self.pool)
            try:
                out = fn()
            finally:
                graph.capture_end()
        trace.count("step.captures")
        return graph, out

    def route(self, g: int) -> torch.Tensor:
        """Step g's frontier pop, dedup and routing, replayed -> idx_q
        (quota, P), the graph's output."""
        if self.routes[g] is None:
            graph, out = self._capture(lambda: _route_core(
                *self.beam, self.rand_all[g], **self.route_kw))
            self.routes[g] = graph, out[-1]
            self.pending[g] = out[:-1]
        graph, idx_q = self.routes[g]
        graph.replay()
        return idx_q

    def update(self, g: int, entries, oks):
        """Step g's decode and update from the round's entries and oks,
        replayed after they are copied into the graph's inputs."""
        _pad_round(entries, oks, self.width, out=self.round_in)
        if self.updates[g] is None:
            self.updates[g], _ = self._capture(lambda: _update_core(
                self.beam, self.stats, self.queries, *self.round_in,
                self.pending.pop(g), g, **self.update_kw))
        self.updates[g].replay()


class FusedPrivateSearch:
    """Host wrapper: fixed-size query groups through the per-step loop."""

    def __init__(self, engine: DevicePianoEngine, start_ids, start_vecs,
                 start_nbrs, dim: int, m: int, n: int):
        self.engine = engine
        dev = engine.device
        self.dim, self.m, self.n = dim, m, n
        self.start_ids = torch.as_tensor(
            np.asarray(start_ids, np.int32), device=dev)
        self.start_vecs = torch.as_tensor(
            np.asarray(start_vecs, np.float32), device=dev)
        self.start_nbrs = torch.as_tensor(
            np.asarray(start_nbrs).astype(np.int32), device=dev)
        self.refreshes = 0          # hint refreshes performed (any cause)
        # maintenance (hint regeneration) is reported apart from query
        # compute, as the reference report's two lines
        # (private-search-report.txt:16,19)
        self.maintenance_s = 0.0        # cumulative, incl. ensure_budget
        self.last_maintenance_s = 0.0   # refresh time inside the last search
        self.refresh_dummy = False      # benchmarking: zeroed-hint refresh
        # device-measured fetch accounting, cumulative over searches:
        # [distinct wanted fetches, quota survivors, PIR-served]
        self.fetch_stats = np.zeros(3, np.int64)
        self.generator = torch.Generator(device=dev)
        self.generator.manual_seed(0)
        # StepGraphs by step shape (Qn, parallel, max_step); m, dim and the
        # engine's P and device are the object's own
        self.step_graphs = {}

    def _refresh(self) -> float:
        """Regenerate the hints (zeroed ones with refresh_dummy). Returns
        the seconds of its "search.refresh" span, which maintenance_s
        sums."""
        with trace.timed("search.refresh") as span:
            if self.refresh_dummy:
                self.engine.dummy_preprocessing()
            else:
                self.engine.preprocessing()
        self.maintenance_s += span.seconds
        self.refreshes += 1
        return span.seconds

    def _steps_fit(self, quota: int) -> int:
        """Worst-case steps the remaining budget can serve (margin matches
        the refresh condition in search())."""
        e = self.engine
        if not e.prepared:
            return 0
        return max(0, (e.params.max_query_num - 11
                       - e.queries_made_in_partition)) // max(quota, 1)

    def ensure_budget(self, max_step: int, n_queries: int, parallel: int,
                      min_steps: int = 1):
        """Refresh hints now if fewer than min_steps of the next such
        search fit the remaining budget (maintenance outside the
        latency-critical path, batch-pir.go:239-245). min_steps=max_step
        restores refresh-before-group."""
        e = self.engine
        quota = n_queries * parallel * self.m // e.config.partition_num
        min_steps = min(min_steps, max_step,
                        (e.params.max_query_num - 11) // max(quota, 1))
        if not e.prepared or self._steps_fit(quota) < min_steps:
            self._refresh()

    def segment_plan(self, max_step: int, quota: int,
                     use_leftover: bool = False) -> list[int]:
        """Split max_step into segments each fitting the per-partition
        budget (pir.go:525-533, group-level). use_leftover sizes the first
        segment to the budget left from earlier searches, so partial
        windows are drained rather than discarded."""
        p = self.engine.params
        per_budget = (p.max_query_num - 2) // max(quota, 1)
        if per_budget < 1:
            raise ValueError(
                f"one step consumes {quota} sub-queries/partition but the "
                f"budget is {p.max_query_num}; use a smaller group")
        lens = []
        left = max_step
        if use_leftover:
            first = min(left, self._steps_fit(quota))
            if first > 0:
                lens.append(first)
                left -= first
        while left > 0:
            lens.append(min(left, per_budget))
            left -= lens[-1]
        return lens

    def run_steps(self, beam, stats, queries_d, rand_all, rnd_all,
                  lo: int, hi: int, *, parallel: int, quota: int,
                  graphs: StepGraphs | None = None):
        """Beam steps [lo, hi) of a group on the engine's device: frontier
        pop, dedup and FCFS routing, the engine's round, decode and update.
        Writes `beam` and `stats` in place; no budget check, refresh or
        bookkeeping, and no copy to the host of its own. graphs: the
        StepGraphs whose buffers beam, stats, queries_d and rand_all are;
        on a CUDA device the routing and update are its graphs' replays."""
        e = self.engine
        P = e.config.partition_num
        graphed = graphs is not None and graphs.graphed
        for g in range(lo, hi):
            with trace.span("step"):
                trace.count("steps")
                if graphed:
                    with trace.span("step.route"):
                        idx_q = graphs.route(g)
                    entries, oks = e._round(idx_q, rnd_all[g])
                    with trace.span("step.update"):
                        graphs.update(g, entries, oks)
                    trace.count("step.graphed")
                    continue
                with trace.span("step.route"):
                    out = _route_core(
                        *beam, rand_all[g], psize=e.config.partition_size,
                        m=self.m, P=P, parallel=parallel, quota=quota,
                        n=self.n)
                entries, oks = e._round(out[-1], rnd_all[g])
                with trace.span("step.update"):
                    _update_core(
                        beam, stats, queries_d,
                        *_pad_round(entries, oks, self.dim + self.m),
                        out[:-1], g, dim=self.dim, m=self.m, P=P,
                        parallel=parallel, quota=quota)

    def _step_graphs(self, Qn: int, parallel: int, max_step: int,
                     quota: int) -> StepGraphs:
        """The StepGraphs of a step shape, made on its first search."""
        key = (Qn, parallel, max_step)
        if key not in self.step_graphs:
            e = self.engine
            self.step_graphs[key] = StepGraphs(
                Qn=Qn, parallel=parallel, max_step=max_step, dim=self.dim,
                m=self.m, P=e.config.partition_num, quota=quota,
                psize=e.config.partition_size, n=self.n, device=e.device)
        return self.step_graphs[key]

    def search(self, queries: np.ndarray, k: int, max_step: int,
               parallel: int, step_randoms=None, return_steps: bool = False):
        """-> (Q, k) int64 answer ids (-1 padded); with return_steps also the
        (Q, k) first-reached step of each answer (search.go:210-233).

        step_randoms: (rand_ids_all (max_step, Q, parallel, m), rnd_all
        (max_step, quota, P, S)) integer arrays or tensors; None draws them
        from self.generator (draw_step_randoms)."""
        e = self.engine
        p = e.params
        dev = e.device
        P = e.config.partition_num
        Qn = queries.shape[0]
        F = Qn * parallel * self.m
        quota = F // P
        if quota < 1:
            raise ValueError("group too small: need Qn*parallel*m >= P")
        seg_lens = self.segment_plan(max_step, quota, use_leftover=True)

        with trace.span("search"):
            bufs = self._step_graphs(Qn, parallel, max_step, quota)
            with trace.span("search.seed"):
                bufs.queries.copy_(torch.as_tensor(
                    np.asarray(queries, np.float32)))
                beam = _seed_beam(bufs.queries, self.start_ids,
                                  self.start_vecs, self.start_nbrs,
                                  parallel=parallel,
                                  cap=bufs.beam[0].shape[1], m=self.m,
                                  out=bufs.beam)
            with trace.span("search.draw"):
                if step_randoms is None:
                    _, rnd_all = draw_step_randoms(
                        self.generator, max_step=max_step, Qn=Qn,
                        parallel=parallel, m=self.m, n=self.n, quota=quota,
                        P=P, S=p.set_size, C=p.chunk_size, device=dev,
                        rand_out=bufs.rand_all)
                else:
                    rand_in, rnd_all = (
                        (a if isinstance(a, torch.Tensor)
                         else torch.from_numpy(np.asarray(a).astype(np.int32)))
                        .to(device=dev, dtype=torch.int32)
                        for a in step_randoms)
                    bufs.rand_all.copy_(rand_in)

            stats = bufs.stats.zero_()
            self.last_maintenance_s = 0.0
            base = 0
            for seg in seg_lens:
                need = seg * quota
                # refresh when the worst-case budget cannot cover this
                # segment (private-search.go:224-230's proactive margin);
                # the estimate is corrected to the device-measured truth
                # after the search
                if (not e.prepared or e.queries_made_in_partition + need + 10
                        >= p.max_query_num):
                    if dev.type == "cuda":
                        # finish the queued steps before the refresh timer
                        # starts
                        with trace.span("search.sync"):
                            torch.cuda.synchronize(dev)
                    self.last_maintenance_s += self._refresh()
                self.run_steps(beam, stats, bufs.queries, bufs.rand_all,
                               rnd_all, base, base + seg, parallel=parallel,
                               quota=quota, graphs=bufs)
                # budget bookkeeping mirrors engine.query
                # (batch-pir.go:239-245)
                e.queries_made_in_partition += need
                e.finished_batch_num += seg * (F // e.config.batch_size)
                base += seg

            with trace.span("search.finish"):
                out_ids, out_steps = finish_topk(beam[0], beam[1], topk=k,
                                                 parallel=parallel, m=self.m)
                # dedup'd and dummy rows never spend budget: resync the
                # estimate to the measured consumption (max of served and
                # backup burn)
                e.queries_made_in_partition = e.consumed()
                got = stats.cpu().numpy()
                self.fetch_stats += got
                for name, v in zip(FETCH_COUNTERS, got.tolist()):
                    trace.count(name, v)
                out_np = out_ids.cpu().numpy().astype(np.int64)
                if return_steps:
                    return out_np, out_steps.cpu().numpy().astype(np.int64)
                return out_np

    def budget_left(self) -> int:
        """Sub-queries a partition may still make in this hint window."""
        e = self.engine
        return e.params.max_query_num - e.queries_made_in_partition

    def fetch_success_rate(self) -> float:
        """Served / distinct-wanted fetches (cumulative, device-measured)."""
        want = int(self.fetch_stats[0])
        return float(self.fetch_stats[2]) / want if want else 1.0
