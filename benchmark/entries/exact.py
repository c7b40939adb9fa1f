"""Entry "exact": one client in a closed loop of exact k-NN batches, each
request a batch of `queries` queries answered with their k nearest ids
(k from the configuration) by the port's exact scan.

Set-up: the deployment's n vectors made on the card near a low-dimensional
manifold (pbench/manifold.py, sift1m_built's data from the same seed
streams), the benchmark's own work whose peak stays out of peak_mem_gb;
then handed to the scan as one float32 (n, d) tensor.

Request i is `queries` fresh manifold queries from (seed, i), made on the
host before the clock starts. The timed call is cli/exact_search.py's
scan: the queries uploaded, graph/recall.py::knn_search(vectors, queries,
k) with its default point block (kernel K6 on the card), the (Q, k) ids
copied to the host. A query of queries_per_s and query_p95_ms is one batch.

The check holds a seeded share of the window's batches (check_share) and
the first, and compares their ids with reference/graph.py::ground_truth's,
id for id (answers_wrong: the held queries whose ids differ, limit 0). On
u8-valued data every fp32 distance is an exact integer, so both sides
order the same distances and break ties by the lower id.

The control rounds the program's distances to bfloat16 before the
selection, below the fp32 the configuration states.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from entries.search import sample_cost
from pbench import manifold, trace
from pbench.cell import TRACE_PASS, WARM, Cell, Context
from pbench.knn import knn_bound
from pbench.sample import Sample


class ExactCell(Cell):
    MIX_KEYS = frozenset({"queries", "warm_batches", "check_share",
                          "trace_batches"})

    def __init__(self, cfg, mix, seed, device, control=False):
        # no PIR engine: no protocol parameters are derived
        super().__init__(dict(cfg, derived={}), mix, seed, device,
                         control=control)
        self.queries, self.k = self.mix["queries"], self.cfg["k"]
        self.vectors = None

    # -- set-up ------------------------------------------------------------

    def make_vectors(self) -> torch.Tensor:
        """The deployment's (n, d) uint8 vectors on the card. The card's
        peak counter restarts once they are made: their making, the
        benchmark's own work, is kept apart in rows_peak."""
        vec = manifold.make_vectors(self.n, seed=self.seed, dim=self.dim,
                                    device=self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            self.rows_peak = torch.cuda.max_memory_allocated(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
        return vec

    def build(self):
        t0 = time.perf_counter()
        vec = self.make_vectors()
        t1 = time.perf_counter()
        self.vectors = vec.float()
        del vec
        self.setup_parts = dict(vectors_s=t1 - t0,
                                upload_s=time.perf_counter() - t1)

    def warm(self):
        for w in range(self.mix["warm_batches"]):
            self._batch(WARM + w)

    def query_vectors(self, i: int) -> np.ndarray:
        return manifold.query_vectors(self.seed, i, self.queries, self.dim)

    @contextlib.contextmanager
    def _distances(self):
        """The control's distances, rounded to bfloat16 before the
        selection; the program's own otherwise."""
        if not self.control:
            yield
            return
        from pacmann_tpu_torch.graph import recall

        exact = recall.l2_distance

        def rounded(*a, **kw):
            return exact(*a, **kw).to(torch.bfloat16).float()

        recall.l2_distance = rounded
        try:
            yield
        finally:
            recall.l2_distance = exact

    def inputs(self, i: int):
        """Request i's inputs, made before its clock starts: its queries."""
        return self.query_vectors(i)

    def call(self, q: np.ndarray) -> np.ndarray:
        """The timed call, cli/exact_search.py's scan: the queries
        uploaded, the k nearest ids of each, copied to the host."""
        from pacmann_tpu_torch.graph.recall import knn_search

        with self._distances():
            qd = torch.as_tensor(q, device=self.device)
            return knn_search(self.vectors, qd, self.k)[1].cpu().numpy()

    def timed_call(self, x):
        """-> (answers, seconds of the call on inputs x)."""
        t0 = time.perf_counter()
        ans = self.call(x)
        return ans, time.perf_counter() - t0

    def _batch(self, i: int):
        """Request i -> (inputs, answers, seconds of the timed call,
        seconds of making its inputs)."""
        t0 = time.perf_counter()
        x = self.inputs(i)
        made = time.perf_counter() - t0
        return (x, *self.timed_call(x), made)

    # -- the window ----------------------------------------------------------

    def window(self, seconds: float) -> dict:
        """wall_s is the window's less the seconds spent making the
        requests' inputs, the benchmark's own work (~4 ms a batch of 1,000
        manifold queries on the host)."""
        sample = Sample(self.seed, share=self.mix["check_share"])
        lat, held, i, made = [], [], 0, 0.0
        t0 = time.perf_counter()
        while True:
            x, ans, dt, make_s = self._batch(i)
            lat.append(dt)
            made += make_s
            held.append(sample.wants(i))
            if held[-1]:
                sample.add(i, ans)
            self.keep(i, x, ans)
            i += 1
            if time.perf_counter() - t0 >= seconds:
                break
        wall = time.perf_counter() - t0 - made
        self.held = sample.held
        return dict(wall_s=wall, requests=i, attempted=i, latency_s=lat,
                    sample_cost=sample_cost(lat, held))

    def keep(self, i: int, x, answers: np.ndarray):
        """What the check keeps of every batch of the window besides the
        held ones (x: the batch's inputs): nothing here."""

    def end_to_end(self, win: dict) -> dict:
        return dict(queries_per_s=win["requests"] / win["wall_s"],
                    query_p95_ms=float(np.percentile(win["latency_s"], 95))
                    * 1e3)

    def knn_bound(self) -> dict:
        return knn_bound(self.n, self.dim, self.queries, self.k)

    # -- the traced run ------------------------------------------------------

    def _batches(self, spans: bool) -> float:
        """The trace_batches traced batches, their inputs made first, each
        call inside the benchmark's span "batch" where `spans`; -> the
        calls' summed latency."""
        xs = [self.inputs(TRACE_PASS + j)
              for j in range(self.mix["trace_batches"])]
        total = 0.0
        for x in xs:
            with trace.span("batch") if spans else contextlib.nullcontext():
                total += self.timed_call(x)[1]
        return total

    def traced(self, win: dict) -> Context:
        unprofiled = self._batches(False)
        tr = trace.profile(lambda: self._batches(True))
        ctx = Context(device=self.device, window=win, counters={}, trace=tr,
                      unprofiled_s=unprofiled,
                      traced=self.mix["trace_batches"], cell=self)
        # what pbench/program.py::tracing_pass returns to the readers
        ctx.program_pass = self.program_pass()
        return ctx

    def program_pass(self):
        """The traced batches twice more: the program's tracing off, then
        on (the first pass after a pause runs slow; pbench/program.py::
        _run_pass). -> the second pass's record (spans, counters), or None
        where the program has no tracing."""
        try:
            from pacmann_tpu_torch.utils import trace as program_trace
        except ImportError:
            return None
        self._batches(False)
        with program_trace.enabled():
            self._batches(False)
        return program_trace.read()

    # -- the check -----------------------------------------------------------

    def release(self):
        self.vectors = None
        super().release()

    def check(self) -> tuple[list, int]:
        """-> ([(name, value, limit)], failed batches)."""
        from reference.graph import ground_truth

        vec = manifold.make_vectors(self.n, seed=self.seed, dim=self.dim,
                                    device=self.device)
        wrong = failed = 0
        for i, ans in sorted(self.held.items()):
            want = ground_truth(vec, torch.as_tensor(self.query_vectors(i)),
                                self.k).cpu().numpy()
            bad = (self.queries if ans.shape != want.shape
                   else int((ans != want).any(axis=1).sum()))
            wrong += bad
            failed += bad > 0
        return [("answers_wrong", wrong, 0)], failed


Entry = ExactCell
