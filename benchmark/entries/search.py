"""Entry "search": one client in a closed loop of private searches, each
request a group of `group` queries through FusedPrivateSearch.search (k,
steps and parallel from the configuration).

Request i has fresh query vectors from (seed, i) and the search's
generator reseeded from (seed, i), as the private driver reseeds it a
group (private/driver.py:256-262). The window starts on a fresh prep;
refreshes fall due inside the searches that need them, real ones, as in
the private driver's loop, and count in those searches' latency.

The check follows a seeded share of the window's searches step by step
in the reference (reference/search.py): their answers, the routing of
every step, the row of every served fetch (an entry fingerprint taken as
the round returns it) and the share of routed fetches the PIR batch did
not serve, held to the configuration's failure bound 2^-failure_prob_log2.
A held search pays for its capture inside its latency: three copies on
the device a step (the round's ids, served mask and entries). The entries'
fingerprint and the copies to the host are made after its latency is
taken, and free the entries again, so no more than one search's entries
are held at a time. The result's `sample_cost` gives the held and the
other searches' median latencies, so that cost shows.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from pbench import data, trace
from pbench.cell import TRACE_PASS, TRACE_SYNC, WARM, Cell, Context
from pbench.sample import Sample
from pbench.syncs import SyncCounter


class SearchCell(Cell):
    MIX_KEYS = frozenset({"group", "warm_searches", "check_share",
                          "sync_searches", "trace_searches"})

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        c = self.cfg
        self.group = self.mix["group"]
        self.k, self.steps, self.parallel = c["k"], c["step"], c["parallel"]
        # the control: the program's own cheaper setting, fewer hints
        # a chunk (half the configuration's failure_prob_log2)
        self.fail = c["failure_prob_log2"] // (2 if self.control else 1)
        self.quota = self.group * self.parallel * self.m // self.derived["P"]

    # -- set-up ------------------------------------------------------------

    def build(self):
        from pacmann_tpu_torch.private.fused_search import FusedPrivateSearch

        self.build_engine(self.fail)
        self.start_ids = data.start_ids(self.seed, self.n, self.cfg["starts"])
        srows = self.row_fn(torch.as_tensor(self.start_ids,
                                            device=self.device)).cpu()
        self.start_vecs = srows[:, :self.dim].contiguous().view(
            torch.float32).numpy()
        self.start_nbrs = srows[:, self.dim:].numpy().astype(np.int64)
        self.fs = FusedPrivateSearch(self.engine, self.start_ids,
                                     self.start_vecs, self.start_nbrs,
                                     dim=self.dim, m=self.m, n=self.n)
        self.weights = data.entry_weights(self.engine.Ep, self.device)

    def warm(self):
        e = self.engine
        e.preprocessing(rng=data.rng(self.seed, data.ENGINE, 0))
        for w in range(self.mix["warm_searches"]):
            # the first as a held search, so that its capture is warm too
            rec = [] if w == 0 else None
            self._search(WARM + w, rec)
            if rec:
                self._fingerprint(rec)
        # the window starts on a fresh budget
        e.preprocessing(rng=data.rng(self.seed, data.ENGINE, 1))
        self.fs.maintenance_s = 0.0
        self.fs.refreshes = 0

    def _search(self, i: int, record: list | None = None):
        """Request i, timed. record: a list that gets copies of (idx_q, ok,
        entries) of every PIR round the search runs."""
        e, fs = self.engine, self.fs
        q = data.query_vectors(self.seed, i, self.group, self.dim)
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
        return q, ans, dt

    # -- the window ----------------------------------------------------------

    def window(self, seconds: float) -> dict:
        sample = Sample(self.seed, share=self.mix["check_share"])
        lat, held, i = [], [], 0
        t0 = time.perf_counter()
        while True:
            rec = [] if sample.wants(i) else None
            q, ans, dt = self._search(i, rec)
            lat.append(dt)
            held.append(rec is not None)
            if rec is not None:
                sample.add(i, dict(queries=q, answers=ans,
                                   **self._fingerprint(rec)))
            i += 1
            if time.perf_counter() - t0 >= seconds:
                break
        wall = time.perf_counter() - t0
        self.held = sample.held
        return dict(wall_s=wall, requests=i, attempted=i * self.group,
                    latency_s=lat, maintenance_s=self.fs.maintenance_s,
                    refreshes=self.fs.refreshes,
                    sample_cost=sample_cost(lat, held))

    def _fingerprint(self, rec: list) -> dict:
        """A held search's rounds on the host: ids, served mask and each
        entry's fingerprint; the entries' copies are freed on the way."""
        idx, ok = (torch.stack([r[j] for r in rec]).cpu().numpy()
                   for j in (0, 1))
        fp = []
        while rec:
            fp.append(data.entry_hash(rec.pop(0)[2], self.weights))
        return dict(idx=idx, ok=ok, fp=torch.stack(fp).cpu().numpy())

    def end_to_end(self, win: dict) -> dict:
        per_query = np.repeat(np.asarray(win["latency_s"]), self.group)
        return dict(queries_per_s=win["attempted"] / win["wall_s"],
                    query_p95_ms=float(np.percentile(per_query, 95)) * 1e3)

    # -- the traced run ------------------------------------------------------

    def traced(self, win: dict) -> Context:
        e, fs = self.engine, self.fs
        counters = {}
        if self.device.type == "cuda":
            counter = SyncCounter()
            inner = fs.run_steps

            def counted(*a, **kw):
                counter.counting = True
                try:
                    return inner(*a, **kw)
                finally:
                    counter.counting = False

            fs.run_steps = counted
            counter.start()
            try:
                for j in range(self.mix["sync_searches"]):
                    self._search(TRACE_SYNC + j)
            finally:
                counter.stop()
                del fs.run_steps
            counters.update(run_steps_syncs=counter.count,
                            run_steps_steps=self.mix["sync_searches"]
                            * self.steps, control_syncs=counter.control)

        def one_pass(spans: bool) -> float:
            if spans:
                rnd, ref = e._round, fs._refresh

                def round_span(*a, **kw):
                    with trace.span("round"):
                        return rnd(*a, **kw)

                def refresh_span():
                    with trace.span("refresh"):
                        return ref()

                e._round, fs._refresh = round_span, refresh_span
            total = 0.0
            try:
                for j in range(self.mix["trace_searches"]):
                    with trace.span("search"):
                        total += self._search(TRACE_PASS + j)[2]
            finally:
                if spans:
                    del e._round, fs._refresh
            return total

        # each pass starts from the same prep, so both do the same work; the
        # prep ends on a synchronize before a pass starts, so neither the
        # wall time nor the profiled device time holds it
        e.preprocessing(rng=data.rng(self.seed, data.TRACE, 0))
        unprofiled = one_pass(False)
        e.preprocessing(rng=data.rng(self.seed, data.TRACE, 0))
        tr = trace.profile(lambda: one_pass(True))
        return Context(device=self.device, window=win,
                       counters=counters, trace=tr, unprofiled_s=unprofiled,
                       traced=self.mix["trace_searches"], cell=self)

    # -- the check -----------------------------------------------------------

    def release(self):
        self.fs = None
        super().release()

    def check(self) -> tuple[list, int]:
        """-> ([(name, value, limit)], failed queries)."""
        from reference.search import beam_search

        dev, d = self.device, self.derived
        starts = (torch.as_tensor(self.start_ids, device=dev),
                  torch.as_tensor(self.start_vecs, device=dev),
                  torch.as_tensor(self.start_nbrs, device=dev))
        answers = routes = rows = kept = served = failed = 0
        shape = (self.steps, self.quota, d["P"])
        for i, h in sorted(self.held.items()):
            if (h["idx"].shape != shape or h["ok"].shape != shape
                    or h["answers"].shape != (self.group, self.k)):
                # rounds or answers of another shape than the cell's
                answers += self.group
                routes += self.steps
                failed += self.group
                continue
            gen = torch.Generator(device=dev)
            gen.manual_seed(data.sub_seed(self.seed, data.SEARCH_GEN, i))
            rand_ids = torch.randint(
                0, self.n, (self.steps, self.group, self.parallel, self.m),
                generator=gen, dtype=torch.int32, device=dev)
            idx = torch.as_tensor(h["idx"], device=dev)
            ok = torch.as_tensor(h["ok"], device=dev)
            want, wrong = beam_search(
                torch.as_tensor(h["queries"], device=dev), starts, rand_ids,
                idx, ok, n=self.n, psize=d["psize"], P=d["P"],
                quota=self.quota, k=self.k, steps=self.steps,
                parallel=self.parallel, m=self.m, row_fn=self.row_fn)
            bad_q = (want.cpu().numpy() != h["answers"]).any(axis=1)
            # every served fetch against its row's fingerprint
            live = (idx >= 0) & ok
            part = torch.arange(d["P"], device=dev).expand_as(idx)
            gid = part[live].long() * d["psize"] + idx[live].long()
            row = torch.zeros((gid.numel(), d["k"] * 128),
                              dtype=torch.int32, device=dev)
            row[:, :self.dim + self.m] = self.row_fn(gid)
            fp = torch.as_tensor(h["fp"], device=dev)[live]
            bad_rows = int((data.entry_hash(row, self.weights)
                            != fp).any(-1).sum())
            answers += int(bad_q.sum())
            routes += len(wrong)
            rows += bad_rows
            kept += int((idx >= 0).sum())
            served += int(live.sum())
            failed += self.group if (wrong or bad_rows) else int(bad_q.sum())
        miss = (kept - served) / kept if kept else 1.0
        return [("answers_wrong", answers, 0), ("routes_wrong", routes, 0),
                ("rows_wrong", rows, 0),
                ("hint_miss_share", miss,
                 2.0 ** -self.cfg["failure_prob_log2"])], failed


def sample_cost(latency_s: list, held: list) -> dict:
    """How many of the window's searches were held for the check, and the
    median latency in ms of those and of the others."""
    lat = np.asarray(latency_s) * 1e3
    mask = np.asarray(held, dtype=bool)
    med = (lambda x: float(np.median(x)) if x.size else None)
    return dict(held=int(mask.sum()), held_median_ms=med(lat[mask]),
                other_median_ms=med(lat[~mask]))


Entry = SearchCell
