"""Entry "batch": one client in a closed loop of batches through the
engine's batch API, DevicePianoEngine.query. Batch i is `ids` ids uniform
on [0, n), drawn from (seed, i), asked with `retries` retry rounds (the
engine's default, 1).

The engine is prepped once, with the rng from (seed, ENGINE, 0); the warm
batches and the window run on from there. A re-prep falls due inside the
call whose budget reading asks for one, continues that generator, and
counts in that batch's latency.

The check replays a seeded share of the window's batches, and the first,
in the reference (reference/batch.py): each round's FCFS table, each
served row, each returned row, the number of rounds, and the share of
the ids some round routed that no round served, held to the
configuration's failure bound 2^-failure_prob_log2. A held batch's
capture is its ids, which of them the engine's cache held at the call's
start, the budget reading at the start (the public state the retry guard
reads), each round's (idx_q, ok, entries) as _round returns them, and the
returned rows. Inside the call the capture only keeps references to the
round's own tensors, which nothing writes again; the cache lookups come
before the batch's latency is taken and the copies to the host after it.
The result's `sample_cost` gives the held and the other batches' median
latencies and the seconds the captures took outside them.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from entries.search import sample_cost
from pbench import data, trace
from pbench.cell import TRACE_PASS, WARM, Cell, Context
from pbench.sample import Sample


class BatchCell(Cell):
    MIX_KEYS = frozenset({"ids", "retries", "warm_batches", "check_share",
                          "trace_batches"})

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        # the control: the program's own cheaper setting, fewer hints a
        # chunk (half the configuration's failure_prob_log2)
        self.fail = self.cfg["failure_prob_log2"] // (2 if self.control
                                                      else 1)
        self.ids, self.retries = self.mix["ids"], self.mix["retries"]

    # -- set-up ------------------------------------------------------------

    def build(self):
        self.build_engine(self.fail)

    def warm(self):
        self.engine.preprocessing(rng=data.rng(self.seed, data.ENGINE, 0))
        for w in range(self.mix["warm_batches"]):
            # the first as a held batch, so that its capture is warm too
            self._batch(WARM + w, {} if w == 0 else None)

    def _batch(self, i: int, record: dict | None = None):
        """Batch i; -> its latency in seconds. record: a dict that gets the
        batch's capture."""
        e = self.engine
        ids = data.rng(self.seed, data.QUERIES, i).integers(0, self.n,
                                                            self.ids)
        if record is not None:
            tc = time.perf_counter()
            rounds = []
            record.update(ids=ids, used=e.queries_made_in_partition,
                          cached=np.array([int(g) in e.cache for g in ids]))
            inner = e._round

            def capturing(idx_q, rnd_q, refresh=None):
                entries, oks = inner(idx_q, rnd_q, refresh)
                rounds.append((idx_q, oks, entries))
                return entries, oks

            e._round = capturing
            capture_s = time.perf_counter() - tc
        try:
            t0 = time.perf_counter()
            out = e.query(ids, retries=self.retries)
            dt = time.perf_counter() - t0
        finally:
            if record is not None:
                del e._round
        if record is not None:
            tc = time.perf_counter()
            record.update(rows=out, **self._host_rounds(rounds),
                          capture_s=capture_s + time.perf_counter() - tc)
        return dt

    def _host_rounds(self, rounds: list) -> dict:
        """A held batch's rounds on the host: idx (rounds, Q, P) local
        indices, ok (rounds, Q, P), entries (rounds, Q, P, k * 128)."""
        if not rounds:
            P = self.derived["P"]
            Q = self.ids // P
            return dict(idx=np.zeros((0, Q, P), np.int32),
                        ok=np.zeros((0, Q, P), bool),
                        entries=np.zeros((0, Q, P, self.engine.Ep),
                                         np.int32))
        return {name: torch.stack([r[j] for r in rounds]).cpu().numpy()
                for j, name in enumerate(("idx", "ok", "entries"))}

    # -- the window ----------------------------------------------------------

    def window(self, seconds: float) -> dict:
        sample = Sample(self.seed, share=self.mix["check_share"])
        lat, held, i = [], [], 0
        t0 = time.perf_counter()
        while True:
            rec = {} if sample.wants(i) else None
            lat.append(self._batch(i, rec))
            held.append(rec is not None)
            if rec is not None:
                sample.add(i, rec)
            i += 1
            if time.perf_counter() - t0 >= seconds:
                break
        wall = time.perf_counter() - t0
        self.held = sample.held
        cost = sample_cost(lat, held)
        cost["capture_s"] = sum(h["capture_s"] for h in self.held.values())
        return dict(wall_s=wall, requests=i, attempted=i, latency_s=lat,
                    sample_cost=cost)

    def end_to_end(self, win: dict) -> dict:
        return dict(queries_per_s=win["requests"] / win["wall_s"],
                    query_p95_ms=float(np.percentile(win["latency_s"], 95))
                    * 1e3)

    # -- the traced run ------------------------------------------------------

    def _batches(self, spans: bool) -> float:
        """The trace_batches traced batches, each inside the benchmark's
        span "batch" where `spans`; -> their summed latency."""
        total = 0.0
        for j in range(self.mix["trace_batches"]):
            if spans:
                with trace.span("batch"):
                    total += self._batch(TRACE_PASS + j)
            else:
                total += self._batch(TRACE_PASS + j)
        return total

    def _fresh_prep(self):
        self.engine.preprocessing(rng=data.rng(self.seed, data.TRACE, 0))

    def traced(self, win: dict) -> Context:
        # each pass starts from the same prep, so all do the same work; the
        # prep ends on a synchronize before a pass starts, so neither the
        # wall time nor the profiled device time holds it
        self._fresh_prep()
        unprofiled = self._batches(False)
        self._fresh_prep()
        tr = trace.profile(lambda: self._batches(True))
        ctx = Context(device=self.device, window=win, counters={}, trace=tr,
                      unprofiled_s=unprofiled,
                      traced=self.mix["trace_batches"], cell=self)
        # what pbench/program.py::tracing_pass returns to the readers
        ctx.program_pass = self.program_pass()
        return ctx

    def program_pass(self):
        """The traced batches twice more, each time from the same prep:
        the program's tracing off, then on (the first pass after a pause
        runs slow; pbench/program.py::_run_pass). -> the second pass's
        record (spans, counters), or None where the program has no
        tracing."""
        try:
            from pacmann_tpu_torch.utils import trace as program_trace
        except ImportError:
            return None
        for on in (False, True):
            self._fresh_prep()
            if on:
                with program_trace.enabled():
                    self._batches(False)
            else:
                self._batches(False)
        return program_trace.read()

    # -- the check -----------------------------------------------------------

    def check(self) -> tuple[list, int]:
        """-> ([(name, value, limit)], failed batches)."""
        from reference.batch import check_batch

        d = self.derived
        total = dict(routes_wrong=0, rows_wrong=0, answers_wrong=0,
                     rounds_wrong=0, routed=0, unserved=0)
        failed = 0
        for _, h in sorted(self.held.items()):
            got = check_batch(h, P=d["P"], psize=d["psize"],
                              retries=self.retries,
                              max_query_num=d["max_query_num"],
                              row_fn=self.row_fn, device=self.device)
            for k in total:
                total[k] += got[k]
            failed += any(got[k] for k in ("routes_wrong", "rows_wrong",
                                           "answers_wrong", "rounds_wrong"))
        routed = total["routed"]
        miss = total["unserved"] / routed if routed else 1.0
        return [(k, total[k], 0) for k in ("routes_wrong", "rows_wrong",
                                           "answers_wrong", "rounds_wrong")] \
            + [("hint_miss_share", miss,
                2.0 ** -self.cfg["failure_prob_log2"])], failed


Entry = BatchCell
