"""Each cell's path at a tiny size on the CPU: the program agrees with the
reference; the control and each fault the cell can have come out not
correct."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from pacmann_tpu_torch.pir import device_engine
from pacmann_tpu_torch.private import fused_search
from pbench import harness
from pbench import spec as specmod

SEED = 2**31 + 11          # seeds may pass 32 signed bits
CELLS = ("tiny.g1", "tiny.g4", "tiny.prep")


def run(root, cell, seconds=0.4, **kw):
    return harness.run_cell(root, cell, SEED, seconds, False, device="cpu",
                            **kw)


def tiny_cell(root, mix):
    """The tiny deployment under a mix, as the harness builds it."""
    spec = specmod.load(root)
    m = specmod.traffic(root, spec, mix)
    return specmod.entry(root, spec, m["entry"])(
        specmod.config(root, spec, "tiny"), m, SEED, "cpu")


@pytest.mark.parametrize("cell", CELLS)
def test_program_agrees_with_the_reference(tiny_root, cell):
    res = run(tiny_root, cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert all(c["value"] <= c["limit"] for c in res["checks"].values())


def test_search_answers_are_not_trivial(tiny_root):
    """The answers the check compares are real vertices, several per query:
    a check of empty answers would pass anything."""
    cell = tiny_cell(tiny_root, "g4")
    cell.build()
    cell.warm()
    cell.window(0.1)
    ans = np.concatenate([h["answers"] for h in cell.held.values()])
    assert (ans >= 0).mean() > 0.9 and len(np.unique(ans)) > ans.shape[1]


def test_profiled_pass_holds_only_the_searches(tiny_root):
    """device_idle's two passes cover the same requests: every host
    operation of the profiled pass lies inside a search, so the prep that
    both passes start from is in neither."""
    cell = tiny_cell(tiny_root, "g4")
    cell.build()
    cell.warm()
    ctx = cell.traced(cell.window(0.1))
    searches = [h for h in ctx.trace.spans if h[0] == "bench.search"]
    assert len(searches) == ctx.traced
    ops = [h for h in ctx.trace.host if not h[0].startswith("bench.")]
    assert ops and all(any(a <= h[1] and h[2] <= b for _, a, b in searches)
                       for h in ops)


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(tiny_root, cell):
    res = run(tiny_root, cell, control=True)
    assert not res["correct"], res["checks"]


def unchanged_beam(*a, **kw):
    return None


def altered_round(self, idx_q, rnd_q, refresh=None):
    entries, oks = self._round_on(self.db, self.state, idx_q, rnd_q, refresh)
    return entries ^ 1, oks


def half_group(search):
    def first_half(self, queries, k, *a, **kw):
        h = max(1, queries.shape[0] // 2)
        out = search(self, queries[:h], k, *a, **kw)
        return np.concatenate([out, np.full((queries.shape[0] - h, k), -1)])
    return first_half


SEARCH_FAULTS = {
    "state_unchanged": (fused_search, "_update_core", unchanged_beam),
    "answer_altered": (device_engine.DevicePianoEngine, "_round",
                       altered_round),
    "half_batch": (fused_search.FusedPrivateSearch, "search",
                   half_group(fused_search.FusedPrivateSearch.search)),
}


# a group of one query has no half to leave out
@pytest.mark.parametrize("cell,fault", [
    (c, f) for c in ("tiny.g1", "tiny.g4") for f in sorted(SEARCH_FAULTS)
    if (c, f) != ("tiny.g1", "half_batch")])
def test_search_fault_is_not_correct(tiny_root, monkeypatch, cell, fault):
    owner, name, fn = SEARCH_FAULTS[fault]
    monkeypatch.setattr(owner, name, fn)
    assert not run(tiny_root, cell)["correct"]


def prep_state_unchanged():
    prep, kept = E._prep_state, []

    def first_kept(self, *a, **kw):
        if not kept:
            prep(self, *a, **kw)
            kept.append(self.state)
        self.state = kept[0]
    return E, "_prep_state", first_kept


def prep_half():
    prep = device_engine.prep_partitions

    def half(db4, *a, **kw):
        table, parities, repl_val, slot_col = prep(db4, *a, **kw)
        parities[parities.shape[0] // 2:] = 0
        return table, parities, repl_val, slot_col
    return device_engine, "prep_partitions", half


def prep_altered():
    prep = device_engine.prep_partitions

    def altered(*a, **kw):
        table, parities, repl_val, slot_col = prep(*a, **kw)
        return table, parities ^ 1, repl_val, slot_col
    return device_engine, "prep_partitions", altered


E = device_engine.DevicePianoEngine
PREP_FAULTS = {"state_unchanged": prep_state_unchanged,
               "half_batch": prep_half, "answer_altered": prep_altered}


@pytest.mark.parametrize("fault", sorted(PREP_FAULTS))
def test_prep_fault_is_not_correct(tiny_root, monkeypatch, fault):
    monkeypatch.setattr(*PREP_FAULTS[fault]())
    assert not run(tiny_root, "tiny.prep")["correct"]


def test_prep_state_unchanged_keeps_the_first_state(monkeypatch):
    """The planted fault does what it says: later preps leave the first
    prep's state in place."""
    monkeypatch.setattr(*prep_state_unchanged())
    raw = np.random.default_rng(0).integers(0, 2**32, (4096, 160),
                                            np.uint32)
    e = E(4096, 640, 32, raw, 8, device="cpu")
    e.preprocessing(rng=np.random.default_rng(1))
    first = e.state["primary_parity"].clone()
    e.preprocessing(rng=np.random.default_rng(2))
    assert torch.equal(first, e.state["primary_parity"])
