"""The batch entry (entries/batch.py) at a tiny size on the CPU, in a copy
of the checkout holding the tiny cells (bench_support.make_tiny_root) and
one more written as a later change would add it: a tiny batch-PIR
deployment of 896-B entries, the shape of big3p2m_b32, under a mix of
batches of 32 ids. The program agrees with reference/batch.py; the control
and each planted fault come out not correct, each on its own check; the
traced run's readers read the program's spans, and read None where the
program lacks them."""

from __future__ import annotations

import ast
import json

import numpy as np
import pytest
import torch
from bench_support import HARNESS, make_tiny_root

from pacmann_tpu_torch.pir import device_engine
from pacmann_tpu_torch.pir.params import (derive_batch_params,
                                          derive_piano_params)
from pbench import harness
from pbench import spec as specmod

SEED = 2**31 + 29          # seeds may pass 32 signed bits
CELL = "tinyb.b32"
N = 8192
BIG = "big3p2m.b32"
NEW = ("batch_host_ms.big3p2m", "batch_syncs.big3p2m",
       "query_idle_share.big3p2m")
E = device_engine.DevicePianoEngine


def derived(n: int, entry_bytes: int, batch: int, fail: int) -> dict:
    c = derive_batch_params(n, entry_bytes, batch, fail)
    p = derive_piano_params(c.partition_size, entry_bytes, fail)
    return dict(P=c.partition_num, psize=c.partition_size, C=p.chunk_size,
                S=p.set_size, Hp=p.primary_hint_num,
                R=p.max_query_per_chunk, T=p.total_tags,
                max_query_num=p.max_query_num, k=2)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """A tiny batch runs ~10x faster on one CPU thread than on a pool."""
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = make_tiny_root(tmp_path_factory.mktemp("checkout"))
    spec = specmod.load(root)
    h = specmod.harness_dir(root, spec)
    cfg = json.loads((h / "configs" / "big3p2m_b32.json").read_text())
    cfg.update(name="tinyb", n=N, reduced=["n"],
               derived=derived(N, cfg["entry_bytes"], cfg["batch"],
                               cfg["failure_prob_log2"]))
    (h / "configs" / "tinyb.json").write_text(json.dumps(cfg))
    mix = specmod.traffic(root, spec, "b32")
    (h / "traffic" / "tb32.json").write_text(json.dumps(dict(
        mix, warm_batches=2, check_share=0.5, trace_batches=3)))
    spec["configs"].append(dict(name="tinyb", source="a test",
                                file=f"{spec['paths'][0]}/configs/tinyb.json",
                                reduced=["n"], why="a test"))
    spec["workloads"].append(dict(name=CELL, config="tinyb", traffic="tb32",
                                  chips=1, why="test"))
    for m in spec["end_to_end"] + spec["per_layer"]:
        if BIG in m.get("workloads", ()):
            m["workloads"] = m["workloads"] + [CELL]
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return root


def run(root, seconds=1.0, trace=False, **kw):
    return harness.run_cell(root, CELL, SEED, seconds, trace, device="cpu",
                            **kw)


def tiny_cell(root):
    spec = specmod.load(root)
    mix = specmod.traffic(root, spec, "tb32")
    return specmod.entry(root, spec, mix["entry"])(
        specmod.config(root, spec, "tinyb"), mix, SEED, "cpu")


def test_batch_cell_agrees_with_the_reference(root):
    res = run(root)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 10 and res["failed"] == 0
    assert {"queries_per_s", "query_p95_ms", "setup_s"} <= set(
        res["metrics"])
    assert res["sample_cost"]["held"] >= 2


def test_held_batches_exercise_every_part_of_the_contract(root):
    """The held batches hold cache hits, ids served in the first round and
    in the retry round, FCFS overflow, and a re-prep inside a call (the
    budget then reads lower than before; near the budget's end the guard
    skips the retry round): a check of none of these would pass a fault
    in it."""
    cell = tiny_cell(root)
    cell.build()
    cell.warm()
    cell.window(1.5)
    held = list(cell.held.values())
    assert sum(h["cached"].sum() for h in held) > 0
    assert sum((h["ok"][0] & (h["idx"][0] >= 0)).sum() for h in held) > 0
    assert sum((h["ok"][1] & (h["idx"][1] >= 0)).sum() for h in held
               if len(h["idx"]) == 2) > 0
    P = cell.derived["P"]
    over = [np.bincount(h["ids"] // cell.derived["psize"], minlength=P)
            .max() > len(h["ids"]) // P for h in held]
    assert any(over)
    used = [h["used"] for _, h in sorted(cell.held.items())]
    assert any(b < a for a, b in zip(used, used[1:]))


def test_control_is_not_correct(root):
    res = run(root, control=True)
    assert not res["correct"]
    assert res["checks"]["hint_miss_share"]["value"] > \
        res["checks"]["hint_miss_share"]["limit"]


def altered_round(self, idx_q, rnd_q, refresh=None):
    entries, oks = self._round_on(self.db, self.state, idx_q, rnd_q, refresh)
    return entries ^ 1, oks


def retry_skipped():
    query = E.query

    def first_round_only(self, ids, retries=None):
        return query(self, ids, 0)
    return E, "query", first_round_only


def slots_swapped():
    online = E._online

    def swapped(self, idx_q, rand_offs, refresh=None):
        return online(self, np.ascontiguousarray(idx_q[::-1]), rand_offs,
                      refresh)
    return E, "_online", swapped


def cache_wrong():
    query = E.query

    def wrong_hits(self, ids, retries=None):
        self.cache = {g: np.full_like(v, 7) for g, v in self.cache.items()}
        return query(self, ids, retries)
    return E, "query", wrong_hits


FAULTS = {
    "row_altered": (lambda: (E, "_round", altered_round), "rows_wrong"),
    "retry_skipped": (retry_skipped, "rounds_wrong"),
    "slots_swapped": (slots_swapped, "routes_wrong"),
    "cache_hit_wrong": (cache_wrong, "answers_wrong"),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(root, monkeypatch, fault):
    plant, check = FAULTS[fault]
    monkeypatch.setattr(*plant())
    res = run(root)
    assert not res["correct"]
    assert res["checks"][check]["value"] > res["checks"][check]["limit"]


def test_traced_run_reads_the_programs_spans(root):
    """On the CPU: the tracing pass's readers give numbers (a call's reads:
    two a round and the budget's two, besides its rounds' claim passes
    and refresh-mask reads), the device trace's gives none (no device
    operations), and the check holds."""
    res = run(root, seconds=0.3, trace=True)
    assert res["correct"]
    got = {k: v["value"] for k, v in res["metrics"].items()}
    assert got["batch_host_ms.big3p2m"] > 0
    assert got["batch_syncs.big3p2m"] >= 2 * 2 + 2 + 2 * 6
    assert "query_idle_share.big3p2m" not in got


def test_readers_give_none_without_the_query_spans(root, monkeypatch):
    """A program whose query() has no span and no counter of its own (the
    parent of the change that added them): the run holds, the readers
    read nothing."""
    monkeypatch.setattr(E, "query", lambda self, ids, retries=None:
                        self._query(ids, retries))
    res = run(root, seconds=0.3, trace=True)
    assert res["correct"]
    assert not set(NEW) & set(res["metrics"])


def test_reference_imports_nothing_of_the_port():
    tree = ast.parse((HARNESS / "reference" / "batch.py").read_text())
    names = {a.name.split(".")[0] for n in ast.walk(tree)
             if isinstance(n, ast.Import) for a in n.names}
    names |= {n.module.split(".")[0] for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom)}
    assert names <= {"__future__", "numpy", "torch"}
