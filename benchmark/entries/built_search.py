"""Entry "built_search": the closed loop of private searches of entry
"search" (entries/search.py), over a graph the server builds in set-up.

Set-up, in order:
  1. the deployment's vectors, made on the card from the seed near a
     low-dimensional manifold (pbench/manifold.py): the benchmark's own
     work, whose peak stays out of peak_mem_gb;
  2. the program's graph build, graph/build.py::build_graph with its
     defaults, recorded with the program's tracing on (its "build" span
     and a "build.<stage>" span a stage, read by build_s.built1m and
     corridor_share.built1m); the build restarts the card's peak counter
     itself, so peak_mem_gb counts from the build on;
  3. the (vector || neighbours) rows handed to the engine, which packs
     them; the rows are then freed. The graph stays on the host, the
     server's data, for the check.
The control is entry "search"'s: the program at half the configuration's
failure_prob_log2.

Request i searches fresh points of the manifold from (seed, i). The check
holds the searches as entry "search" does, against rows the reference
makes from the remade vectors and the graph's host copy, and adds:
graph_rows_wrong, the graph's rows that break build_graph's contract
(limit 0), and recall_miss, 1 - recall@k of every search of the window
(their answers are kept on the host as they return, after each search's
latency is taken) against brute-force ground truth over all n vectors
(reference/graph.py).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from entries.search import SearchCell
from pbench import data, manifold
from pbench.cell import WARM, derived_params

# 1 - recall@10's limit, by the rule PERF.md §6 writes down: the lowest
# sound recall@10 of 8 runs (a process each, over every search of the
# window; PERF.md §4 gives the readings) less 0.02, as a miss, rounded up
# to the third decimal
RECALL_MISS_LIMIT = 0.180


class BuiltSearchCell(SearchCell):

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.graph = None
        self.build_recording = None
        # the window's answers, by request
        self.answers = {}

    def build_engine(self, failure_prob_log2: int):
        from pacmann_tpu_torch.graph import build
        from pacmann_tpu_torch.pir.device_engine import DevicePianoEngine
        from pacmann_tpu_torch.utils import trace

        dev = self.device
        t0 = time.perf_counter()
        vec = manifold.make_vectors(self.n, seed=self.seed, dim=self.dim,
                                    device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            self.rows_peak = torch.cuda.max_memory_allocated(dev)
        t1 = time.perf_counter()
        # read at once: a later enabled() starts from a clean slate
        with trace.enabled():
            graph = build.build_graph(
                vec, self.m, seed=data.sub_seed(self.seed, manifold.BUILD),
                device=dev)
        self.build_recording = trace.read()
        t2 = time.perf_counter()
        self.graph = torch.from_numpy(np.array(graph, np.int32))
        raw = torch.cat([vec.float().view(torch.int32),
                         self.graph.to(dev)], dim=1)
        del vec
        self.engine = DevicePianoEngine(
            self.n, self.entry_bytes, self.cfg["batch"], raw,
            failure_prob_log2, device=dev)
        del raw
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        self.setup_parts = dict(vectors_s=t1 - t0, graph_s=t2 - t1,
                                pack_s=time.perf_counter() - t2)
        got = derived_params(self.engine)
        if failure_prob_log2 == self.cfg["failure_prob_log2"] and \
                got != self.derived:
            raise ValueError(f"the engine derives {got}, the "
                             f"configuration states {self.derived}")

    def row_fn(self, gid: torch.Tensor) -> torch.Tensor:
        """(len(gid), dim + m) int32 rows: the remade vectors' float32
        bits, then the ids of the graph's host copy."""
        vec = manifold.vectors(gid, seed=self.seed, n=self.n, dim=self.dim)
        nbr = self.graph[gid.cpu().long()].to(gid.device)
        return torch.cat([vec.float().view(torch.int32), nbr], dim=1)

    def _search(self, i: int, record: list | None = None):
        """Request i, timed, as entry "search" runs it, on the request's
        manifold queries; a window request's answers are kept. record: as
        there."""
        e, fs = self.engine, self.fs
        q = manifold.query_vectors(self.seed, i, self.group, self.dim)
        fs.generator.manual_seed(data.sub_seed(self.seed, data.SEARCH_GEN,
                                               i))
        if record is not None:
            inner = e._round

            def capturing(idx_q, rnd_q, refresh=None):
                entries, oks = inner(idx_q, rnd_q, refresh)
                record.append((idx_q.clone(), oks.clone(), entries.clone()))
                return entries, oks

            e._round = capturing
        try:
            t0 = time.perf_counter()
            ans = fs.search(q, k=self.k, max_step=self.steps,
                            parallel=self.parallel)
            dt = time.perf_counter() - t0
        finally:
            if record is not None:
                del e._round
        if i < WARM:
            self.answers[i] = ans
        return q, ans, dt

    def check(self) -> tuple[list, int]:
        from reference.graph import graph_rows_wrong, ground_truth, recall

        checks, failed = super().check()
        done = sorted(self.answers)
        queries = np.concatenate([manifold.query_vectors(
            self.seed, i, self.group, self.dim) for i in done])
        answers = np.concatenate([self.answers[i] for i in done])
        vec = manifold.make_vectors(self.n, seed=self.seed, dim=self.dim,
                                    device=self.device)
        gnd = ground_truth(vec, torch.as_tensor(queries), self.k).cpu()
        del vec
        got = recall(gnd.numpy(), answers, self.k)
        return checks + [
            ("graph_rows_wrong", graph_rows_wrong(self.graph, self.n,
                                                  self.m), 0),
            ("recall_miss", 1.0 - got, RECALL_MISS_LIMIT)], failed


Entry = BuiltSearchCell
