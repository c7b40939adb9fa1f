"""The built-graph cell (entries/built_search.py) at a small size on the
CPU: 8,192 manifold vectors, the graph built in set-up by the program,
the same entry and reference code as built1m.g1. The program agrees with
the reference, its recall taken over every search of the window; the
control (half the failure bound), a built row with a repeated or its own
id, uniform neighbour lists in place of the graph, and an altered served
row each come out not correct; the new reference files import nothing of
the port; the new readers give None where the spans and counters are
absent."""

from __future__ import annotations

import json
import subprocess
import sys
import types

import numpy as np
import pytest
import torch
from bench_support import HARNESS, TINY_N, make_tiny_root, tiny_derived

from pacmann_tpu_torch.graph import build
from pacmann_tpu_torch.pir import device_engine
from pbench import data, harness, manifold
from pbench import spec as specmod

SEED = 2**31 + 23          # seeds may pass 32 signed bits
CELL = "tiny.built"
READERS = ("build_s.built1m", "corridor_share.built1m",
           "fetches_per_step.built1m")


@pytest.fixture(scope="module")
def built_root(tmp_path_factory):
    """A checkout root with the tiny cells and tiny.built: the built-graph
    deployment at n = 8,192 under mix g1b."""
    root = make_tiny_root(tmp_path_factory.mktemp("built"))
    spec = specmod.load(root)
    h = specmod.harness_dir(root, spec)
    cfg = json.loads((h / "configs" / "sift1m_built.json").read_text())
    cfg.update(name="tiny_built", n=TINY_N, starts=64,
               derived=tiny_derived(TINY_N, cfg["batch"],
                                    cfg["failure_prob_log2"]))
    (h / "configs" / "tiny_built.json").write_text(json.dumps(cfg))
    spec["configs"].append(dict(
        name="tiny_built", source="a test",
        file=f"{spec['paths'][0]}/configs/tiny_built.json", reduced=["n"],
        why="a test"))
    spec["workloads"].append(dict(name=CELL, config="tiny_built",
                                  traffic="g1b", chips=1, why="test"))
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "built1m.g1" in m.get("workloads", []):
            m["workloads"] = m["workloads"] + [CELL]
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return root


@pytest.fixture(scope="module")
def built_graph():
    """The graph the cell's set-up builds at SEED, built once here."""
    vec = manifold.make_vectors(TINY_N, seed=SEED, dim=128, device="cpu")
    return build.build_graph(vec, 32, seed=data.sub_seed(SEED,
                                                         manifold.BUILD),
                             device="cpu")


def run(root, trace=False, **kw):
    return harness.run_cell(root, CELL, SEED, 0.4, trace, device="cpu",
                            **kw)


def test_program_agrees_with_the_reference(built_root, built_graph):
    res = run(built_root)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    checks = res["checks"]
    assert {"answers_wrong", "routes_wrong", "rows_wrong", "hint_miss_share",
            "graph_rows_wrong", "recall_miss"} == set(checks)
    assert checks["graph_rows_wrong"]["value"] == 0
    assert checks["recall_miss"]["value"] < 0.05
    # peak_mem_gb is the card's alone
    assert set(res["metrics"]) == {"query_p95_ms", "setup_s"}
    assert set(res["setup_parts"]) >= {"vectors_s", "graph_s", "pack_s"}


def test_traced_run_reads_the_build_and_the_fetches(built_root):
    res = run(built_root, trace=True)
    assert res["correct"], res["checks"]
    got = {name: res["metrics"][name]["value"] for name in READERS}
    assert 0 < got["build_s.built1m"] < res["setup_parts"]["graph_s"]
    assert 0 < got["corridor_share.built1m"] < 100
    # the group's 96 fetches a step, fewer once the dedup drops known ids
    assert 0 < got["fetches_per_step.built1m"] < 96


def uniform_lists(n: int, m: int) -> np.ndarray:
    """(n, m) int32 neighbour lists drawn uniformly: neighbour j of vertex
    u is u + 1 + j * w + r modulo n, r uniform in [0, w), w = (n - 1) // m,
    so each row holds m distinct ids other than its own."""
    w = (n - 1) // m
    r = np.random.default_rng(7).integers(0, w, size=(n, m))
    u = np.arange(n)[:, None]
    return ((u + 1 + np.arange(m) * w + r) % n).astype(np.int32)


def altered_graph(built_graph, fault):
    g = np.array(built_graph)
    if fault == "repeated_id":
        g[5, 1] = g[5, 0]
    else:
        g[5, 1] = 5
    return lambda *a, **kw: g


def altered_round(self, idx_q, rnd_q, refresh=None):
    entries, oks = self._round_on(self.db, self.state, idx_q, rnd_q, refresh)
    return entries ^ 1, oks


@pytest.mark.parametrize("fault", ("repeated_id", "self_id"))
def test_a_row_breaking_the_graph_contract_is_not_correct(
        built_root, built_graph, monkeypatch, fault):
    monkeypatch.setattr(build, "build_graph",
                        altered_graph(built_graph, fault))
    res = run(built_root)
    assert not res["correct"]
    assert res["checks"]["graph_rows_wrong"]["value"] == 1


def test_recall_is_taken_over_every_search_of_the_window(built_root,
                                                        built_graph):
    """recall_miss is 1 - recall@10 of all the window's searches, not only
    of those held for the step-by-step check."""
    from entries.built_search import BuiltSearchCell
    from reference.graph import ground_truth, recall

    spec = specmod.load(built_root)
    cfg = specmod.config(built_root, spec, "tiny_built")
    mix = specmod.traffic(built_root, spec, "g1b")
    cell = BuiltSearchCell(cfg, mix, SEED, torch.device("cpu"))
    cell.build()
    cell.warm()
    win = cell.window(0.4)
    assert sorted(cell.answers) == list(range(win["requests"]))
    assert len(cell.held) < win["requests"]
    cell.release()
    checks = {name: v for name, v, _ in cell.check()[0]}
    q = np.concatenate([manifold.query_vectors(SEED, i, 1, 128)
                        for i in range(win["requests"])])
    vec = manifold.make_vectors(TINY_N, seed=SEED, dim=128, device="cpu")
    gnd = ground_truth(vec, torch.as_tensor(q), 10).numpy()
    got = np.concatenate([cell.answers[i] for i in range(win["requests"])])
    assert checks["recall_miss"] == 1.0 - recall(gnd, got, 10)


def test_control_is_not_correct(built_root, built_graph, monkeypatch):
    """The control, the program at half the configuration's
    failure_prob_log2, misses the failure bound; the graph keeps its
    contract."""
    monkeypatch.setattr(build, "build_graph", lambda *a, **kw: built_graph)
    res = run(built_root, control=True)
    c = res["checks"]
    assert not res["correct"], c
    assert c["hint_miss_share"]["value"] > c["hint_miss_share"]["limit"]
    assert c["graph_rows_wrong"]["value"] == 0


def test_uniform_lists_miss_the_recall_limit(built_root, monkeypatch):
    """Uniform neighbour lists in place of the built graph (each row m
    distinct ids, none its own) fail recall_miss alone."""
    lists = uniform_lists(TINY_N, 32)
    monkeypatch.setattr(build, "build_graph", lambda *a, **kw: lists)
    res = run(built_root)
    c = res["checks"]
    assert not res["correct"]
    assert c["recall_miss"]["value"] > c["recall_miss"]["limit"]
    assert c["graph_rows_wrong"]["value"] == 0
    assert all(c[k]["value"] <= c[k]["limit"] for k in c
               if k != "recall_miss")


def test_an_altered_served_row_is_not_correct(built_root, built_graph,
                                              monkeypatch):
    monkeypatch.setattr(build, "build_graph", lambda *a, **kw: built_graph)
    monkeypatch.setattr(device_engine.DevicePianoEngine, "_round",
                        altered_round)
    res = run(built_root)
    assert not res["correct"]
    assert res["checks"]["rows_wrong"]["value"] > 0


def test_reference_and_data_import_nothing_of_the_port():
    code = (f"import sys; sys.path.insert(0, {str(HARNESS)!r}); "
            "import reference.graph, pbench.manifold; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    loaded = set(eval(proc.stdout.strip().splitlines()[-1]))
    assert "torch" in loaded and "reference" in loaded
    assert not loaded & {"pacmann_tpu_torch", "pacmann_tpu", "jax",
                         "jaxlib", "flax"}


@pytest.mark.parametrize("name", READERS)
def test_readers_give_none_without_the_spans(built_root, name):
    """On a program without the build's spans or the fetch counters (the
    recording a parent program leaves), or with no tracing at all."""
    spec = specmod.load(built_root)
    read = specmod.reader(built_root, spec, name)
    no_spans = types.SimpleNamespace(spans=[], counters={"steps": 80})
    for rec in (no_spans, None):
        ctx = types.SimpleNamespace(
            cell=types.SimpleNamespace(build_recording=rec, engine=None),
            program_pass=rec)
        assert read(ctx) is None


def test_ground_truth_breaks_ties_to_the_lower_id():
    from reference.graph import ground_truth, recall

    v = torch.tensor([[0, 0], [3, 4], [0, 0], [5, 0], [1, 1]]).float()
    q = torch.tensor([[0, 0], [4, 0]]).float()
    assert ground_truth(v, q, 3).tolist() == [[0, 2, 4], [3, 4, 0]]
    # duplicates count once, as ComputeRecall counts them
    assert recall(np.array([[0, 2, 4]]), np.array([[0, 0, 9]]), 3) == \
        pytest.approx(1 / 3)
