"""The harness finds what a cell names by name, and BENCHMARK.json keeps
to the benchmark's contract."""

from __future__ import annotations

import json
import re

import pytest
from bench_support import ROOT

from pbench import harness
from pbench import spec as specmod

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
WIDTH = re.compile(r"(_dim|_rank|_size|_bytes)$|^(d|m)$")


@pytest.fixture(scope="module")
def spec():
    return specmod.load(ROOT)


def test_every_cell_names_files_that_exist(spec):
    for w in spec["workloads"]:
        cfg = specmod.config(ROOT, spec, w["config"])
        assert cfg["name"] == w["config"]
        mix = specmod.traffic(ROOT, spec, w["traffic"])
        entry = specmod.entry(ROOT, spec, mix["entry"])
        assert set(mix) - {"entry", "loop", "clients"} == entry.MIX_KEYS
    for m in spec["per_layer"]:
        assert callable(specmod.reader(ROOT, spec, m["name"]))


def test_finds_what_a_later_change_adds(tiny_root):
    """The tiny cells exist only as files and entries a test wrote into a
    copy of the checkout: a configuration, a mix and a metric reader."""
    spec = specmod.load(tiny_root)
    assert specmod.config(tiny_root, spec, "tiny")["n"] == 8192
    assert specmod.traffic(tiny_root, spec, "g4")["group"] == 4
    h = specmod.harness_dir(tiny_root, spec)
    (h / "metrics" / "traced_requests.py").write_text(
        "def read(ctx):\n    return ctx.traced\n")
    spec["per_layer"].append(dict(
        name="traced_requests", unit="requests", better="higher",
        source="program_counter", layer="fused search",
        moves="queries_per_s", workloads=["tiny.g4"]))
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))
    try:
        res = harness.run_cell(tiny_root, "tiny.g4", 5, 0.2, True,
                               device="cpu")
    finally:
        spec["per_layer"].pop()
        (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))
    assert res["metrics"]["traced_requests"] == {"value": 1,
                                                 "unit": "requests"}
    assert res["correct"]


def test_finds_an_entry_a_later_change_adds(tiny_root):
    """An entry file and a mix naming it, written into the copy, run as a
    cell of their own."""
    spec = specmod.load(tiny_root)
    h = specmod.harness_dir(tiny_root, spec)
    (h / "entries" / "prep_again.py").write_text(
        (h / "entries" / "prep.py").read_text())
    (h / "traffic" / "prep_again.json").write_text(json.dumps(dict(
        specmod.traffic(tiny_root, spec, "prep"), entry="prep_again")))
    spec["workloads"].append(dict(name="tiny.prep_again", config="tiny",
                                  traffic="prep_again", chips=1, why="test"))
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))
    try:
        res = harness.run_cell(tiny_root, "tiny.prep_again", 5, 0.2, False,
                               device="cpu")
    finally:
        spec["workloads"].pop()
        (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))
    assert res["correct"] and res["attempted"] >= 1


@pytest.mark.parametrize("change", [
    dict(clients=8), dict(loop="open"), dict(rate_per_s=20.0)])
def test_a_mix_the_entry_does_not_run_is_refused(change):
    """A mix key the entry does not read, or a loop or client count it
    does not run, is refused, not run as one closed-loop client."""
    spec = specmod.load(ROOT)
    mix = dict(specmod.traffic(ROOT, spec, "g1"), **change)
    cfg = specmod.config(ROOT, spec, "sift1m_b32")
    with pytest.raises(specmod.SpecError):
        specmod.entry(ROOT, spec, mix["entry"])(cfg, mix, 1, "cpu")


def test_unknown_names_raise(spec):
    with pytest.raises(specmod.SpecError):
        specmod.workload(spec, "no.such.cell")
    with pytest.raises(specmod.SpecError):
        specmod.traffic(ROOT, spec, "no_such_mix")
    with pytest.raises(specmod.SpecError):
        specmod.reader(ROOT, spec, "no_such_metric")
    with pytest.raises(specmod.SpecError):
        specmod.entry(ROOT, spec, "no_such_entry")


def test_benchmark_json_keeps_to_the_contract(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert spec["command"][:1] == ["python3"] and len(spec["command"]) <= 32
    assert all(LINE.match(w) for w in spec["command"])
    for p in spec["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", p)
        assert not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
    assert all(w.startswith(tuple(spec["paths"])) or w == "python3"
               for w in spec["command"])
    assert 1 <= spec["run_seconds"] <= 51
    # a full check of 24 cells (2 + 14 runs a cell) fits in 43,200 s
    assert (2 + 14 * 24) * (spec["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    configs = {c["name"]: c for c in spec["configs"]}
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and LINE.match(c["source"])
        assert LINE.match(c["why"]) and len(c["reduced"]) <= 16
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["reduced"] == c["reduced"] and data["source"] == \
            c["source"]
        for key in c["reduced"]:
            assert NAME.match(key) and key in data
            assert not WIDTH.search(key), f"{key} is a width"
    names = [w["name"] for w in spec["workloads"]]
    assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in spec["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert LINE.match(w["why"])
    assert sum(w["chips"] == 4 for w in spec["workloads"]) <= max(
        1, len(names) // 4)
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    metric_names = list(e2e) + [m["name"] for m in spec["per_layer"]]
    assert len(metric_names) == len(set(metric_names))
    for m in spec["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in spec["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert LINE.match(m["layer"]) and m["moves"] in e2e
        for w in m.get("workloads", names):
            assert specmod.applies(e2e[m["moves"]], w), \
                f"{m['name']} moves {m['moves']}, which {w} does not report"
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", names)) <= set(names)
    for w in names:
        own = [m["name"] for m in spec["end_to_end"]
               if specmod.applies(m, w)]
        assert "setup_s" in own and len(own) >= 2
        assert any(specmod.applies(m, w) for m in spec["per_layer"])
    assert len(json.dumps(spec)) <= 64 * 1024
