"""The exact-scan and plaintext-search cells (entries/exact.py,
entries/plain_search.py) at a small size on the CPU: 8,192 manifold
vectors, the plaintext cell's graph built by the program in set-up, the
same entry and reference code as exact1m.q1000 and plain1m.q1000. Both
come out correct; planted faults each come out not correct (distances in
bfloat16 before the selection, the scan's last point block left out, one
answer id altered, a beam step's accept mask altered, uniform neighbour
lists in place of the graph); a mix key an entry does not read is refused;
the new reference imports nothing of the port; the new readers give None
where the program's spans and counters are absent."""

from __future__ import annotations

import json
import subprocess
import sys
import types

import numpy as np
import pytest
import torch
from bench_support import HARNESS, TINY_N, make_tiny_root
from test_bench_built import uniform_lists

from pacmann_tpu_torch.graph import beam, build, recall
from pbench import data, harness, manifold
from pbench import spec as specmod

SEED = 2**31 + 41          # seeds may pass 32 signed bits
EXACT, PLAIN = "tiny.exact", "tiny.plain"
READERS = ("knn_roofline.exact1m", "k6_roofline.exact1m",
           "select_device_ms.exact1m", "step_device_ms.plain1m",
           "device_idle.plain1m")


@pytest.fixture(scope="module")
def plain_root(tmp_path_factory):
    """A checkout root with the tiny cells and tiny.exact (mix q1000x) and
    tiny.plain (64 queries a batch) on sift1m_plain at n = 8,192."""
    root = make_tiny_root(tmp_path_factory.mktemp("plain"))
    spec = specmod.load(root)
    h = specmod.harness_dir(root, spec)
    cfg = json.loads((h / "configs" / "sift1m_plain.json").read_text())
    cfg.update(name="tiny_plain", n=TINY_N, starts=int(np.sqrt(TINY_N)))
    (h / "configs" / "tiny_plain.json").write_text(json.dumps(cfg))
    mix = json.loads((h / "traffic" / "q1000p.json").read_text())
    (h / "traffic" / "q64p.json").write_text(json.dumps(
        dict(mix, queries=64, check_share=0.5)))
    spec["configs"].append(dict(
        name="tiny_plain", source="a test",
        file=f"{spec['paths'][0]}/configs/tiny_plain.json", reduced=["n"],
        why="a test"))
    spec["workloads"] += [
        dict(name=EXACT, config="tiny_plain", traffic="q1000x", chips=1,
             why="test"),
        dict(name=PLAIN, config="tiny_plain", traffic="q64p", chips=1,
             why="test")]
    for m in spec["end_to_end"] + spec["per_layer"]:
        for cell, real in ((EXACT, "exact1m.q1000"),
                           (PLAIN, "plain1m.q1000")):
            if real in m.get("workloads", []):
                m["workloads"] = m["workloads"] + [cell]
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return root


@pytest.fixture(scope="module")
def built_graph():
    """The graph the plaintext cell's set-up builds at SEED, built once."""
    vec = manifold.make_vectors(TINY_N, seed=SEED, dim=128, device="cpu")
    return build.build_graph(vec, 32, seed=data.sub_seed(SEED,
                                                         manifold.BUILD),
                             device="cpu")


@pytest.fixture
def graph_built(monkeypatch, built_graph):
    monkeypatch.setattr(build, "build_graph", lambda *a, **kw: built_graph)


def run(root, cell, trace=False, **kw):
    return harness.run_cell(root, cell, SEED, 0.4, trace, device="cpu", **kw)


def test_exact_scan_agrees_with_the_reference(plain_root):
    res = run(plain_root, EXACT)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["checks"]) == {"answers_wrong"}
    # peak_mem_gb is the card's alone
    assert set(res["metrics"]) == {"queries_per_s", "query_p95_ms",
                                   "setup_s"}


def test_plaintext_search_agrees_with_the_reference(plain_root,
                                                    graph_built):
    res = run(plain_root, PLAIN)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    c = res["checks"]
    assert set(c) == {"answers_wrong", "graph_rows_wrong", "recall_miss"}
    assert c["answers_wrong"]["value"] == 0
    assert c["graph_rows_wrong"]["value"] == 0
    assert c["recall_miss"]["value"] < 0.05
    assert set(res["metrics"]) == {"queries_per_s", "query_p95_ms",
                                   "setup_s"}


@pytest.mark.parametrize("cell", (EXACT, PLAIN))
def test_traced_runs_are_correct_and_record_the_program(plain_root,
                                                        graph_built,
                                                        monkeypatch, cell):
    """A --trace 1 run stays correct; its tracing pass holds the program's
    request spans and counters (the device readers read nothing on the
    CPU)."""
    passes = []
    inner = harness.specmod.reader

    def spying(root, spec, name):
        read = inner(root, spec, name)

        def spy(ctx):
            passes.append(ctx.program_pass)
            return read(ctx)
        return spy

    monkeypatch.setattr(harness.specmod, "reader", spying)
    res = run(plain_root, cell, trace=True)
    assert res["correct"], res["checks"]
    rec = passes[0]
    mix = "q1000x" if cell == EXACT else "q64p"
    spec = specmod.load(plain_root)
    batches = specmod.traffic(plain_root, spec, mix)["trace_batches"]
    queries = specmod.traffic(plain_root, spec, mix)["queries"]
    request = "knn" if cell == EXACT else "ann"
    assert sum(s.name == request for s in rec.spans) == batches
    assert rec.counters[f"{request}.queries"] == batches * queries


def test_control_is_not_correct(plain_root):
    """The exact cell's control: the program's distances rounded to
    bfloat16 before the selection."""
    res = run(plain_root, EXACT, control=True)
    assert not res["correct"]
    assert res["checks"]["answers_wrong"]["value"] > 0


def test_plaintext_control_is_not_correct(plain_root, monkeypatch):
    """The plaintext cell's control: the program at half the steps. On
    uniform lists, where the beam is still far from converged at half the
    steps (on the small built graph ten steps often find the same top-10,
    so a window holding one batch may show no difference)."""
    lists = uniform_lists(TINY_N, 32)
    monkeypatch.setattr(build, "build_graph", lambda *a, **kw: lists)
    res = run(plain_root, PLAIN, control=True)
    assert not res["correct"]
    assert res["checks"]["answers_wrong"]["value"] > 0


def test_the_last_point_block_left_out_is_not_correct(plain_root,
                                                      monkeypatch):
    real = recall.knn_search

    def short(vectors, queries, k, **kw):
        return real(vectors[:-1024], queries, k, p_block=1024)

    monkeypatch.setattr(recall, "knn_search", short)
    res = run(plain_root, EXACT)
    assert not res["correct"]
    assert res["checks"]["answers_wrong"]["value"] > 0


@pytest.mark.parametrize("cell", (EXACT, PLAIN))
def test_one_altered_answer_id_is_not_correct(plain_root, graph_built,
                                              monkeypatch, cell):
    if cell == EXACT:
        real = recall.knn_search

        def altered(*a, **kw):
            d, ids = real(*a, **kw)
            ids[0, 3] = (ids[0, 3] + 1) % TINY_N
            return d, ids

        monkeypatch.setattr(recall, "knn_search", altered)
    else:
        real = beam.PlaintextEngine.search

        def altered(self, *a, **kw):
            ids, steps = real(self, *a, **kw)
            ids[0, 3] = (ids[0, 3] + 1) % TINY_N
            return ids, steps

        monkeypatch.setattr(beam.PlaintextEngine, "search", altered)
    res = run(plain_root, cell)
    assert not res["correct"]
    assert res["checks"]["answers_wrong"]["value"] >= 1


def test_an_altered_accept_mask_is_not_correct(plain_root, graph_built,
                                               monkeypatch):
    """A beam step that accepts every copy of a candidate within the step
    (no dedup among the step's fetches)."""
    monkeypatch.setattr(beam, "first_occurrence",
                        lambda ids: torch.ones_like(ids, dtype=torch.bool))
    res = run(plain_root, PLAIN)
    assert not res["correct"]
    assert res["checks"]["answers_wrong"]["value"] > 0


def test_uniform_lists_miss_the_recall_limit(plain_root, monkeypatch):
    """Uniform neighbour lists in place of the built graph (each row m
    distinct ids, none its own) fail recall_miss alone: the reference
    searches the same lists."""
    lists = uniform_lists(TINY_N, 32)
    monkeypatch.setattr(build, "build_graph", lambda *a, **kw: lists)
    res = run(plain_root, PLAIN)
    c = res["checks"]
    assert not res["correct"]
    assert c["recall_miss"]["value"] > c["recall_miss"]["limit"]
    assert c["answers_wrong"]["value"] == 0
    assert c["graph_rows_wrong"]["value"] == 0


@pytest.mark.parametrize("mix", ("q1000x", "q1000p"))
def test_a_mix_key_the_entry_does_not_read_is_refused(mix):
    from bench_support import ROOT

    spec = specmod.load(ROOT)
    cfg = specmod.config(ROOT, spec, "sift1m_plain")
    bad = dict(specmod.traffic(ROOT, spec, mix), group=64)
    with pytest.raises(specmod.SpecError):
        specmod.entry(ROOT, spec, bad["entry"])(cfg, bad, 1, "cpu")


def test_reference_imports_nothing_of_the_port():
    code = (f"import sys; sys.path.insert(0, {str(HARNESS)!r}); "
            "import reference.plain, reference.graph, pbench.knn; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    loaded = set(eval(proc.stdout.strip().splitlines()[-1]))
    assert "torch" in loaded and "reference" in loaded
    assert not loaded & {"pacmann_tpu_torch", "pacmann_tpu", "jax",
                         "jaxlib", "flax"}


@pytest.mark.parametrize("name", READERS)
def test_readers_give_none_without_the_program_or_the_card(plain_root,
                                                           name):
    """On the CPU, or on a program without the new spans and counters (a
    parent program's trace and tracing pass)."""
    spec = specmod.load(plain_root)
    read = specmod.reader(plain_root, spec, name)
    trace = types.SimpleNamespace(host=[], device=[], launch_ts={},
                                  kernel_s=lambda pattern: 0.0,
                                  busy_s=lambda: 0.0)
    ctx = types.SimpleNamespace(
        device=torch.device("cpu"), window={"latency_s": [0.05]},
        trace=trace, traced=4, unprofiled_s=0.2,
        program_pass=types.SimpleNamespace(spans=[], counters={}),
        cell=types.SimpleNamespace(knn_bound=lambda: {"bound_ms": 3.8}))
    assert read(ctx) is None
