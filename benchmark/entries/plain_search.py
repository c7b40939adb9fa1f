"""Entry "plain_search": one client in a closed loop of plaintext beam
searches, each request a batch of `queries` queries through
graph/beam.py::PlaintextEngine.search (k, step and parallel from the
configuration), over a graph the server builds in set-up.

Set-up, in order (entry "built_search"'s, up to the graph):
  1. the deployment's vectors, made on the card near a low-dimensional
     manifold (pbench/manifold.py): the benchmark's own work, whose peak
     stays out of peak_mem_gb;
  2. the program's graph build, graph/build.py::build_graph with its
     defaults and the seed stream built1m.g1's build takes, recorded with
     the program's tracing on (kept as build_recording); the build
     restarts the card's peak counter itself, so peak_mem_gb counts from
     the build on;
  3. PlaintextEngine(vectors, graph) on the card, which starts every search
     from the first sqrt(n) ids. The graph's host copy stays, the server's
     data, for the check.

Request i is `queries` fresh manifold queries from (seed, i) and the
padding ids a pop that finds its frontier empty fetches instead
(step_randoms: (queries, step, parallel, m) ids uniform in [0, n), drawn on
the card from (seed, i)), both made before the clock starts. The timed
call is the engine's search, whose ids come back to the host. A query of
queries_per_s and query_p95_ms is one batch.

The check:
  answers_wrong     the held batches (check_share and the first) against
                    reference/plain.py's beam on the remade vectors and the
                    graph's host copy, id for id (limit 0);
  graph_rows_wrong  the graph's rows that break build_graph's contract
                    (limit 0);
  recall_miss       1 - recall@k of the first `recall_queries` queries of
                    every batch of the window (kept on the host as the
                    batch returns) against reference/graph.py::
                    ground_truth, the float64 brute force. All of every
                    batch would be ~2M queries, minutes of brute force.
The control is the program at half the configuration's steps.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from entries.exact import ExactCell
from pbench import data, manifold
from pbench.cell import WARM

# 1 - recall@10's limit, by built_search's rule (PERF.md §4 writes it down
# before the readings): the lowest sound recall@10 of 8 runs (a process
# each, over the recall queries of every batch of the window) less 0.02, as
# a miss, rounded up to the third decimal
RECALL_MISS_LIMIT = 0.164


class PlainSearchCell(ExactCell):
    MIX_KEYS = ExactCell.MIX_KEYS | {"recall_queries"}

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        c = self.cfg
        self.steps, self.parallel = c["step"], c["parallel"]
        # the control: the program at half the configuration's steps
        self.run_steps = self.steps // (2 if self.control else 1)
        self.recall_queries = self.mix["recall_queries"]
        self.graph = None
        self.build_recording = None
        # the window's recall queries and their answers, by request
        self.recall_batches = {}

    def build(self):
        from pacmann_tpu_torch.graph import build
        from pacmann_tpu_torch.graph.beam import PlaintextEngine
        from pacmann_tpu_torch.utils import trace

        dev = self.device
        t0 = time.perf_counter()
        vec = self.make_vectors()
        t1 = time.perf_counter()
        # read at once: a later enabled() starts from a clean slate
        with trace.enabled():
            graph = build.build_graph(
                vec, self.m, seed=data.sub_seed(self.seed, manifold.BUILD),
                device=dev)
        self.build_recording = trace.read()
        t2 = time.perf_counter()
        self.graph = torch.from_numpy(np.array(graph, np.int32))
        self.engine = PlaintextEngine(vec, graph, device=dev)
        del vec
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        self.setup_parts = dict(vectors_s=t1 - t0, graph_s=t2 - t1,
                                engine_s=time.perf_counter() - t2)

    def step_randoms(self, i: int) -> torch.Tensor:
        """Request i's padding ids, (queries, step, parallel, m) int32."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(data.sub_seed(self.seed, data.SEARCH_GEN, i))
        return torch.randint(
            0, self.n, (self.queries, self.steps, self.parallel, self.m),
            generator=gen, dtype=torch.int32, device=self.device)

    def inputs(self, i: int):
        return self.query_vectors(i), self.step_randoms(i)

    def call(self, x) -> np.ndarray:
        """The timed call: the engine's search of the batch, ids to the
        host."""
        q, rand = x
        return self.engine.search(
            q, k=self.k, max_step=self.run_steps, parallel=self.parallel,
            step_randoms=rand[:, :self.run_steps])[0]

    def keep(self, i: int, x, answers: np.ndarray):
        if i < WARM:
            r = self.recall_queries
            self.recall_batches[i] = (x[0][:r].copy(), answers[:r].copy())

    def check(self) -> tuple[list, int]:
        """-> ([(name, value, limit)], failed batches)."""
        from reference.graph import graph_rows_wrong, ground_truth, recall
        from reference.plain import beam_search

        dev = self.device
        vec = manifold.make_vectors(self.n, seed=self.seed, dim=self.dim,
                                    device=dev)
        starts = torch.arange(self.cfg["starts"], device=dev)
        vf = vec.float()
        wrong = failed = 0
        for i, ans in sorted(self.held.items()):
            q, rand = self.inputs(i)
            want = beam_search(vf, self.graph, starts,
                               torch.as_tensor(q, device=dev), rand,
                               k=self.k, steps=self.steps,
                               parallel=self.parallel).cpu().numpy()
            bad = (self.queries if ans.shape != want.shape
                   else int((ans != want).any(axis=1).sum()))
            wrong += bad
            failed += bad > 0
        del vf
        done = sorted(self.recall_batches)
        queries = np.concatenate([self.recall_batches[i][0] for i in done])
        answers = np.concatenate([self.recall_batches[i][1] for i in done])
        gnd = ground_truth(vec, torch.as_tensor(queries), self.k).cpu()
        got = recall(gnd.numpy(), answers, self.k)
        return [("answers_wrong", wrong, 0),
                ("graph_rows_wrong", graph_rows_wrong(self.graph, self.n,
                                                      self.m), 0),
                ("recall_miss", 1.0 - got, RECALL_MISS_LIMIT)], failed


Entry = PlainSearchCell
