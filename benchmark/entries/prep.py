"""Entry "prep": hint generations back to back, DevicePianoEngine.
preprocessing with prep i's rng from (seed, i): the offline phase a client
pays at every hint window.

The check works out again, in the reference (reference/prep.py), the state
that a seeded sample of the window's preps left, and the state the last
prep left: at `check_hints` primary and `check_hints` backup hints of every
partition, the PRF table row, the parity and the slot columns, and
`check_hints` replacement entries, compared bit for bit. A held prep's
capture (a few small gathers and their copy to the host) runs inside the
window, after the prep's own time is taken; the result's `sample_cost`
gives how many preps were held and the seconds their captures took.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from pbench import bounds, data, trace
from pbench.cell import Cell, Context
from pbench.sample import Sample

CONTROL_ROUNDS = 4          # the control's PRF: AES-128 cut to 4 rounds


class PrepCell(Cell):
    MIX_KEYS = frozenset({"warm_preps", "check_sample", "check_hints",
                          "trace_preps"})

    def build(self):
        self.build_engine(self.cfg["failure_prob_log2"])

    def warm(self):
        for w in range(self.mix["warm_preps"]):
            self.engine.preprocessing(rng=data.rng(self.seed, data.ENGINE, w))

    def _positions(self, i: int):
        """Prep i's sampled hints (P, 2h) and replacements (P, h, 2)."""
        d, h = self.derived, self.mix["check_hints"]
        r = data.rng(self.seed, data.SAMPLE, 1, i)
        P = d["P"]
        hints = np.concatenate([r.integers(0, d["Hp"], (P, h)),
                                r.integers(d["Hp"], d["T"], (P, h))], 1)
        repl = np.stack([r.integers(0, d["S"], (P, h)),
                         r.integers(0, d["R"], (P, h))], -1)
        return hints, repl

    def _capture(self, i: int) -> dict:
        """The state the engine holds now, at prep i's sampled positions."""
        st, d = self.engine.state, self.derived
        hints, repl = self._positions(i)
        h = hints.shape[1] // 2
        dev = self.device
        p = torch.arange(d["P"], device=dev)[:, None]
        t = torch.as_tensor(hints, device=dev)
        tp, tb = t[:, :h], t[:, h:]
        rs = torch.as_tensor(repl[..., 0], device=dev)
        rr = torch.as_tensor(repl[..., 1], device=dev)
        got = dict(table=st["table"][p, t],
                   parity=torch.cat([st["primary_parity"][p, tp],
                                     st["backup_parity"][p, tb - d["Hp"]]],
                                    1),
                   slot_col=st["slot_col"][p, :, tp],
                   repl_idx=st["repl_idx"][p, rs, rr],
                   repl_val=st["repl_val"][p, rs, rr])
        return dict({k: v.cpu() for k, v in got.items()}, hints=hints,
                    repl=repl)

    def window(self, seconds: float) -> dict:
        e = self.engine
        sample = Sample(self.seed, size=self.mix["check_sample"])
        times, captures, capture_s, i = [], 0, 0.0, 0
        t0 = time.perf_counter()
        while True:
            e.preprocessing(rng=data.rng(self.seed, data.PREP, i))
            times.append(e.preprocessing_time)
            if sample.wants(i):
                tc = time.perf_counter()
                sample.add(i, self._capture(i))
                capture_s += time.perf_counter() - tc
                captures += 1
            i += 1
            if time.perf_counter() - t0 >= seconds:
                break
        wall = time.perf_counter() - t0
        self.held = dict(sample.held)
        if i - 1 not in self.held:
            self.held[i - 1] = self._capture(i - 1)
        return dict(wall_s=wall, requests=i, attempted=i, prep_s=times,
                    sample_cost=dict(held=captures, capture_s=capture_s))

    def end_to_end(self, win: dict) -> dict:
        return dict(prep_ms=win["wall_s"] / win["requests"] * 1e3)

    # -- the traced run ------------------------------------------------------

    def traced(self, win: dict) -> Context:
        e = self.engine
        R = self.mix["trace_preps"]

        def one_pass(spans: bool) -> float:
            total = 0.0
            for j in range(R):
                rng = data.rng(self.seed, data.TRACE, j)
                if spans:
                    with trace.span("prep"):
                        e.preprocessing(rng=rng)
                else:
                    e.preprocessing(rng=rng)
                total += e.preprocessing_time
            return total

        unprofiled = one_pass(False)
        tr = trace.profile(lambda: one_pass(True))
        return Context(device=self.device, window=win,
                       counters={}, trace=tr, unprofiled_s=unprofiled,
                       traced=R, cell=self)

    def offsets(self):
        """The installed state's (P, T, S) offsets and the skip mask."""
        d = self.derived
        t = torch.arange(d["T"], device=self.device)[:, None]
        s = torch.arange(d["S"], device=self.device)[None, :]
        skip = (t >= d["Hp"]) & (s == torch.div(t - d["Hp"], d["R"],
                                                rounding_mode="floor"))
        return self.engine.state["table"], skip[None].expand(d["P"], -1, -1)

    def prep_bound(self) -> dict:
        off, skip = self.offsets()
        return bounds.prep_bound(off, skip, self.engine.state,
                                 C=self.derived["C"],
                                 psize=self.derived["psize"], n=self.n,
                                 entry_bytes=self.entry_bytes)

    def k2_bound(self) -> dict:
        off, skip = self.offsets()
        return bounds.gather_bound(off, skip, self.derived["C"],
                                   self.derived["k"])[0]

    # -- the check -----------------------------------------------------------

    def check(self) -> tuple[list, int]:
        from reference.prep import hint_sample

        d, E = self.derived, self.dim + self.m
        table = parity = repl = failed = 0
        for i, got in sorted(self.held.items()):
            kw = dict(P=d["P"], S=d["S"], R=d["R"], C=d["C"], Hp=d["Hp"],
                      psize=d["psize"], n=self.n, row_fn=self.row_fn,
                      device=self.device)
            want = {k: v.cpu() for k, v in hint_sample(
                data.rng(self.seed, data.PREP, i), got["hints"],
                got["repl"], **kw).items()}
            if self.control:
                # the reference, cut short, in the program's place
                cut = hint_sample(data.rng(self.seed, data.PREP, i),
                                  got["hints"], got["repl"],
                                  rounds=CONTROL_ROUNDS, **kw)
                got = dict(got, table=cut["table"].cpu(),
                           slot_col=cut["table"][:, :got["hints"].shape[1]
                                                 // 2].cpu(),
                           parity=pad(cut["parity"].cpu(), d["k"] * 128),
                           repl_idx=cut["repl_idx"].cpu(),
                           repl_val=pad(cut["repl_val"].cpu(), d["k"] * 128))
            h = got["hints"].shape[1] // 2
            bad_t = int((got["table"].long() != want["table"]).sum()
                        + (got["slot_col"].long() != want["table"][:, :h])
                        .sum())
            bad_p = int(((got["parity"][..., :E] != want["parity"]).any(-1)
                         | (got["parity"][..., E:] != 0).any(-1)).sum())
            bad_r = int(((got["repl_idx"].long() != want["repl_idx"])
                         | (got["repl_val"][..., :E] != want["repl_val"])
                         .any(-1)
                         | (got["repl_val"][..., E:] != 0).any(-1)).sum())
            table += bad_t
            parity += bad_p
            repl += bad_r
            failed += bool(bad_t or bad_p or bad_r)
        return [("table_words_wrong", table, 0),
                ("parities_wrong", parity, 0),
                ("replacements_wrong", repl, 0)], failed


def pad(x: torch.Tensor, words: int) -> torch.Tensor:
    out = torch.zeros(x.shape[:-1] + (words,), dtype=x.dtype)
    out[..., :x.shape[-1]] = x
    return out


Entry = PrepCell
