"""The port's tracing (pacmann_tpu_torch/utils/trace.py) on the CPU: off it
records nothing, reads no clock but its two timed spans' and never opens a
record_function; on (enabled() or an active torch.profiler) its spans nest
by parent and request, sit in the profiler's trace around the operations
of their phase, and change no answer and no state; the sync counters count
their sites."""

import contextlib
import json

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode
from torch.profiler import ProfilerActivity, profile

from pacmann_tpu.parallel.sharding import make_mesh as jmake_mesh
from pacmann_tpu.pir.device_engine import DevicePianoEngine as JaxEngine
from pacmann_tpu.pir.sharded_engine import (
    ChunkShardedPianoEngine as JaxChunkSharded)
from pacmann_tpu_torch.parallel.sharding import make_mesh
from pacmann_tpu_torch.pir import device_engine
from pacmann_tpu_torch.pir.convert import state_to_numpy
from pacmann_tpu_torch.pir.device_engine import DevicePianoEngine
from pacmann_tpu_torch.pir.sharded_engine import ChunkShardedPianoEngine
from pacmann_tpu_torch.private.fused_search import FusedPrivateSearch
from pacmann_tpu_torch.utils import trace

torch.set_num_threads(1)

N, D, M = 1024, 8, 8


def _search(seed=5, prepared=True):
    """A tiny engine on the CPU and its fused search; unprepared, its first
    search refreshes before its first step."""
    rng = np.random.default_rng(seed)
    vectors = rng.integers(0, 8, size=(N, D)).astype(np.float32)
    graph = rng.integers(0, N, size=(N, M))
    raw = np.concatenate([vectors.view(np.uint32),
                          graph.astype(np.uint32)], axis=1)
    e = DevicePianoEngine(N, 4 * (D + M), M, raw, 8, device="cpu")
    if prepared:
        e.preprocessing(rng=np.random.default_rng(seed + 1))
    sids = rng.choice(N, 32, replace=False)
    fs = FusedPrivateSearch(e, sids, vectors[sids], graph[sids], dim=D, m=M,
                            n=N)
    return fs, rng.integers(0, 8, size=(2, D)).astype(np.float32)


def _run(fs, queries, max_step=6):
    fs.generator.manual_seed(3)
    return fs.search(queries, k=5, max_step=max_step, parallel=2)


class _NoClock:
    def perf_counter_ns(self):
        raise AssertionError("the clock was read while tracing is off")


def _no_record_function(name):
    raise AssertionError(f"record_function({name!r}) while tracing is off")


def test_off_is_a_shared_no_op(monkeypatch):
    with trace.enabled():
        pass
    monkeypatch.setattr(trace, "time", _NoClock())
    monkeypatch.setattr(trace, "record_function", _no_record_function)
    assert trace.span("a") is trace.span("b")
    with trace.span("search"):
        with trace.span("step"):
            trace.count("steps")
    assert trace.read() == ([], {})


def test_off_search_reads_the_clock_in_its_timed_spans_alone(monkeypatch):
    """A search that refreshes twice, tracing off: two clock reads a timed
    span (its prep and its refresh), none elsewhere, no record_function,
    no record."""
    fs, q = _search(prepared=False)
    reads = []

    class Clock:
        def perf_counter_ns(self):
            reads.append(1)
            return len(reads) * 1000

    with trace.enabled():
        pass
    monkeypatch.setattr(trace, "time", Clock())
    monkeypatch.setattr(trace, "record_function", _no_record_function)
    per = (fs.engine.params.max_query_num - 2) // (2 * 2 * M // fs.engine
                                                   .config.partition_num)
    _run(fs, q, max_step=per + 1)
    assert fs.refreshes == 2
    preps = fs.refreshes
    assert len(reads) == 2 * (preps + fs.refreshes)
    assert trace.read() == ([], {})
    assert fs.maintenance_s > 0 and fs.engine.preprocessing_time > 0


def test_enabled_resets_and_nests():
    with trace.enabled():
        trace.count("x", 3)
        with trace.span("round"):
            pass
    assert trace.read().counters == {"x": 3}
    with trace.enabled():
        with trace.span("search"):
            with trace.span("step"):
                trace.count("steps")
                trace.count("steps")
                with trace.timed("prep"):
                    pass
        with trace.span("prep"):
            with trace.span("prep.k1"):
                pass
        with trace.span("round"):
            pass
    rec = trace.read()
    assert rec.counters == {"steps": 2}
    by = {s.name: s for s in rec.spans}
    assert [s.name for s in rec.spans] == ["prep", "step", "search",
                                           "prep.k1", "prep", "round"]
    search, step = by["search"], by["step"]
    inner_prep, outer_prep = rec.spans[0], rec.spans[4]
    assert search.parent is None and search.request == search.id
    assert step.parent == search.id and step.request == search.id
    assert inner_prep.parent == step.id and inner_prep.request == search.id
    assert outer_prep.request == outer_prep.id
    assert by["prep.k1"].parent == outer_prep.id
    assert by["prep.k1"].request == outer_prep.id
    assert by["round"].parent is None and by["round"].request is None
    assert len({s.id for s in rec.spans}) == len(rec.spans)
    for s in rec.spans:
        assert s.start_ns <= s.end_ns
    assert search.start_ns <= step.start_ns <= step.end_ns <= search.end_ns


def test_a_profiled_search_keeps_nothing_in_memory():
    """Under a profiler alone the spans are annotations of its trace, and
    neither a span record nor a counter is kept."""
    fs, q = _search(prepared=False)
    with trace.enabled():
        trace.count("x")
    with trace.enabled():
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _run(fs, q, max_step=3)
    assert trace.read() == ([], {})
    assert trace._open == []
    names = {e.name for e in prof.events()}
    assert {"pacmann.search", "pacmann.round", "pacmann.prep"} <= names


def test_the_profiler_flag_turns_tracing_on():
    """torch's private flag, which the tracing reads, flips under
    torch.profiler.profile, and spans are live while it is set."""
    flag = torch.autograd.profiler
    assert not flag._is_profiler_enabled
    assert trace.span("a") is trace.span("a")
    with profile(activities=[ProfilerActivity.CPU]):
        assert flag._is_profiler_enabled
        assert trace.span("a") is not trace.span("a")
    assert not flag._is_profiler_enabled
    assert trace.span("a") is trace.span("a")


@pytest.fixture(scope="module")
def profiled(tmp_path_factory):
    """A tiny search (one refresh inside it) under torch.profiler and
    enabled(): its chrome trace's host events and the tracing's own
    records."""
    fs, q = _search(prepared=False)
    with trace.enabled(), profile(activities=[ProfilerActivity.CPU]) as prof:
        _run(fs, q, max_step=3)
    path = tmp_path_factory.mktemp("trace") / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X"]
    return events, trace.read()


@pytest.mark.parametrize("name,parent,op", [
    ("search", None, "aten::copy_"),
    ("search.seed", "search", "aten::sum"),
    ("search.draw", "search", "aten::randint"),
    ("search.refresh", "search", None),
    ("prep", "search.refresh", None),
    ("prep.draw", "prep", None),
    ("prep.keys", "prep", None),
    ("prep.upload", "prep", "aten::copy_"),
    ("prep.k1", "prep", None),
    ("prep.k2", "prep", "aten::bitwise_xor_"),
    ("prep.repl", "prep", "aten::index"),
    ("prep.state", "prep", "aten::repeat"),
    ("step", "search", None),
    ("step.route", "step", "aten::cumsum"),
    ("round", "step", None),
    ("round.select", "round", "aten::cumsum"),
    ("round.claim", "round.select", "aten::argmax"),
    ("round.scan", "round", "aten::bitwise_xor_"),
    ("round.finish", "round", "aten::nonzero"),
    ("step.update", "step", "aten::repeat_interleave"),
    ("search.finish", "search", "aten::sort"),
])
def test_spans_are_annotations_around_their_phase(profiled, name, parent,
                                                  op):
    """Each span is a user_annotation pacmann.<name> inside its parent's,
    as many as the records hold, and holds op (an operation of its phase)
    where one is given."""
    events, rec = profiled
    ann = [e for e in events if e.get("cat") == "user_annotation"]
    mine = [e for e in ann if e["name"] == trace.PREFIX + name]
    assert mine and len(mine) == sum(s.name == name for s in rec.spans)

    def inside(e, outer):
        return (outer["ts"] <= e["ts"]
                and e["ts"] + e["dur"] <= outer["ts"] + outer["dur"])

    ops = [e for e in events if e.get("cat") == "cpu_op"]
    for e in mine:
        if op is not None:
            assert op in {o["name"] for o in ops if inside(o, e)}
        if parent is not None:
            assert any(inside(e, o) for o in ann
                       if o["name"] == trace.PREFIX + parent)


def _state(fs):
    return {k: v.copy() for k, v in state_to_numpy(fs.engine.state).items()}


@pytest.mark.parametrize("what", ("search", "prep"))
def test_tracing_changes_no_answer_and_no_state(what):
    out = []
    for on in (False, True):
        fs, q = _search(prepared=what == "search")
        with trace.enabled() if on else contextlib.nullcontext():
            if what == "search":
                ans = _run(fs, q)
            else:
                fs.engine.preprocessing(rng=np.random.default_rng(9))
                ans = None
        out.append((ans, _state(fs), fs.fetch_stats.copy()))
    (a0, s0, f0), (a1, s1, f1) = out
    assert (a0 is None and a1 is None) or np.array_equal(a0, a1)
    assert np.array_equal(f0, f1) and s0.keys() == s1.keys()
    for key in s0:
        assert np.array_equal(s0[key], s1[key]), key


@pytest.mark.parametrize("form,per_round", (("scatter", 6), ("dense", 0)))
def test_sync_counters_count_their_sites(monkeypatch, form, per_round):
    """sync.refresh_mask: one a boolean-mask read of the refresh (each
    seen by a TorchFunctionMode around _pir_finish), six a scatter round
    (one round a step; the CPU takes K8's plain version), none on the
    dense form; finish.fused: one a scatter round, none on the dense form;
    sync.claim: one a pass of the claim fixpoint (its bool())."""
    monkeypatch.setenv("PACMANN_REFRESH_ROUTE", form)
    passes, reads = [], []

    def counted(x):
        passes.append(1)
        return bool(x)

    class MaskReads(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            if (func is torch.Tensor.__getitem__
                    and isinstance(args[1], torch.Tensor)
                    and args[1].dtype == torch.bool):
                reads.append(1)
            return func(*args, **(kwargs or {}))

    finish = device_engine._pir_finish

    def watched(*args, **kwargs):
        with MaskReads():
            return finish(*args, **kwargs)

    monkeypatch.setattr(device_engine, "bool", counted, raising=False)
    monkeypatch.setattr(device_engine, "_pir_finish", watched)
    fs, q = _search()
    with trace.enabled():
        _run(fs, q)
    rec = trace.read()
    c = rec.counters
    rounds = sum(s.name == "round" for s in rec.spans)
    assert c["steps"] == rounds == 6
    assert c.get("sync.refresh_mask", 0) == len(reads) == per_round * rounds
    assert c.get("finish.fused", 0) == (rounds if form == "scatter" else 0)
    assert c["sync.claim"] == len(passes) >= rounds


def test_cpu_steps_are_not_graphed():
    """On the CPU every beam step runs eagerly: two traced searches of one
    shape count their steps, each inside a route and an update span, and
    no step.graphed and no step.captures."""
    fs, q = _search()
    with trace.enabled():
        _run(fs, q)
        _run(fs, q)
    rec = trace.read()
    c = rec.counters
    assert c["steps"] == 12
    assert c.get("step.graphed", 0) == 0 and c.get("step.captures", 0) == 0
    for name in ("step", "step.route", "step.update"):
        assert sum(s.name == name for s in rec.spans) == 12, name


def test_timed_spans_are_the_engine_and_search_times():
    """preprocessing_time is its prep span's length and maintenance_s the
    sum of the search's refresh spans; last_maintenance_s is the last
    search's share."""
    fs, q = _search(prepared=False)
    per = (fs.engine.params.max_query_num - 2) // (2 * 2 * M // fs.engine
                                                   .config.partition_num)
    with trace.enabled():
        _run(fs, q, max_step=per + 1)
    rec = trace.read()
    preps = [s for s in rec.spans if s.name == "prep"]
    refreshes = [s for s in rec.spans if s.name == "search.refresh"]
    assert len(preps) == len(refreshes) == fs.refreshes == 2
    assert fs.engine.preprocessing_time == pytest.approx(
        (preps[-1].end_ns - preps[-1].start_ns) * 1e-9, abs=1e-12)
    spans_s = sum((s.end_ns - s.start_ns) * 1e-9 for s in refreshes)
    assert fs.maintenance_s == pytest.approx(spans_s, abs=1e-9)
    assert fs.last_maintenance_s == pytest.approx(fs.maintenance_s)
    fs.ensure_budget(per + 1, 2, 2, min_steps=per + 1)
    assert fs.refreshes == 3 and fs.maintenance_s > spans_s


# -- the engine's batch API (DevicePianoEngine.query) ------------------------

BATCH_IDS = 16          # 4 a partition: the tiny engine has P = 4


def _batch_engine(seed=5):
    """A tiny prepped engine on the CPU and the id batches it is asked."""
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 2**32, size=(N, D + M), dtype=np.uint32)
    e = DevicePianoEngine(N, 4 * (D + M), M, raw, 8, device="cpu")
    e.preprocessing(rng=np.random.default_rng(seed + 1))
    return e, rng.integers(0, N, size=(40, BATCH_IDS))


def _batches_until_reprep(e, batches):
    """Query batches until one re-preps inside its call; -> the answers."""
    out = []
    for ids in batches:
        before = e.queries_made_in_partition
        out.append(e.query(ids))
        if e.queries_made_in_partition < before or not e.cache:
            return out
    raise AssertionError("no batch re-prepped")


def test_query_is_a_request_holding_its_phases():
    e, batches = _batch_engine()
    with trace.enabled():
        for ids in batches[:3]:
            e.query(ids)
    rec = trace.read()
    queries = [s for s in rec.spans if s.name == "query"]
    assert len(queries) == rec.counters["queries"] == 3
    for q in queries:
        assert q.parent is None and q.request == q.id
        mine = [s for s in rec.spans if s.request == q.id and s is not q]
        assert {s.name for s in mine if s.parent == q.id} == {
            "query.fill", "round", "query.read", "query.budget"}
        assert {s.name for s in mine} >= {"round.select", "round.scan",
                                          "round.finish"}
        for s in mine:
            assert q.start_ns <= s.start_ns <= s.end_ns <= q.end_ns


# each engine form beside its JAX twin: the plain engine, a measure_comm
# one, and the chunk-sharded one over eight CPU shards
ROUND_FORMS = {
    "plain": (lambda *a: JaxEngine(*a),
              lambda *a: DevicePianoEngine(*a, device="cpu")),
    "measured": (lambda *a: JaxEngine(*a, measure_comm=True),
                 lambda *a: DevicePianoEngine(*a, device="cpu",
                                              measure_comm=True)),
    "chunk_sharded": (lambda *a: JaxChunkSharded(*a, jmake_mesh(8)),
                      lambda *a: ChunkShardedPianoEngine(
                          *a, make_mesh(devices=["cpu"] * 8))),
}


@pytest.mark.parametrize("form", sorted(ROUND_FORMS))
def test_each_round_is_one_tree_on_every_engine(form):
    """Each query() round opens exactly one "round" span, holding one
    "round.select", one "round.scan" and one "round.finish", on every
    engine form; the answers, the state and the measured bytes equal the
    JAX twin's."""
    rng = np.random.default_rng(80)
    n, eb, batch = 4096, 32, 4
    raw = rng.integers(0, 2**32, size=(n, 8), dtype=np.uint32)
    make_ref, make_got = ROUND_FORMS[form]
    ref, got = make_ref(n, eb, batch, raw, 20), make_got(n, eb, batch, raw, 20)
    for e in (ref, got):
        e.preprocessing(rng=np.random.default_rng(100))
    with trace.enabled():
        for b in range(3):
            ids = [int(i) for i in rng.integers(0, n, batch)]
            for e in (ref, got):
                e._rng = np.random.default_rng(b)
            assert np.array_equal(got.query(ids), ref.query(ids))
    rec = trace.read()
    rounds = [s for s in rec.spans if s.name == "round"]
    assert len(rounds) == rec.counters["query.rounds"] >= 3
    phases = ["round.finish", "round.scan", "round.select"]
    for r in rounds:
        assert sorted(s.name for s in rec.spans if s.parent == r.id) == phases
    for name in phases:
        assert sum(s.name == name for s in rec.spans) == len(rounds)
    want = {k: np.asarray(v).astype(np.uint32) for k, v in ref.state.items()}
    have = state_to_numpy(got.state)
    assert set(have) == set(want)
    for key in want:
        assert np.array_equal(have[key], want[key]), key
    assert got.queries_made_in_partition == ref.queries_made_in_partition
    assert got.uploaded_bytes == ref.uploaded_bytes
    assert got.downloaded_bytes == ref.downloaded_bytes
    assert (got.uploaded_bytes > 0) == (form == "measured")


@pytest.mark.parametrize("retries", (0, 1, 2))
def test_query_counters_count_calls_rounds_and_reads(retries):
    """queries one a call, query.rounds 1 + retries a call, sync.query_read
    one a device->host read outside the rounds (each .cpu() and int()
    seen by a TorchFunctionMode): two a round and consumed()'s two;
    query.unserved the answers left zero."""
    e, batches = _batch_engine()
    reads, in_round = [], []
    inner = e._round

    def round_unwatched(*a, **kw):
        in_round.append(1)
        try:
            return inner(*a, **kw)
        finally:
            in_round.pop()

    class Reads(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            if not in_round and func in (torch.Tensor.cpu,
                                         torch.Tensor.__int__):
                reads.append(func)
            return func(*args, **(kwargs or {}))

    e._round = round_unwatched
    calls, zero_rows = 2, 0
    with trace.enabled(), Reads():
        for ids in batches[:calls]:
            out = e.query(ids, retries=retries)
            zero_rows += int((out == 0).all(axis=1).sum())
    c = trace.read().counters
    assert c["queries"] == calls
    assert c["query.rounds"] == calls * (1 + retries)
    assert c["sync.query_read"] == len(reads) == 2 * c["query.rounds"] \
        + 2 * calls
    assert c["query.unserved"] == zero_rows


def test_a_reprep_inside_a_call_sits_under_its_prep_span():
    e, batches = _batch_engine()
    with trace.enabled():
        _batches_until_reprep(e, batches)
    rec = trace.read()
    by_id = {s.id: s for s in rec.spans}
    preps = [s for s in rec.spans if s.name == "prep"]
    assert len(preps) == rec.counters["preps"] == 1
    prep = preps[0]
    budget = by_id[prep.parent]
    query = by_id[budget.parent]
    assert budget.name == "query.budget" and query.name == "query"
    assert prep.request == query.id == query.request
    assert {s.name for s in rec.spans if s.parent == prep.id} >= {
        "prep.draw", "prep.keys", "prep.upload", "prep.k1", "prep.k2"}
    assert query.start_ns <= prep.start_ns <= prep.end_ns <= query.end_ns


@pytest.mark.parametrize("traced", ("enabled", "profiler"))
def test_traced_queries_answer_and_leave_state_as_untraced_ones(traced):
    """The same batches, across a re-prep inside a call, on two engines
    from the same seeds: traced and not, the same answers, state, cache,
    budget and generator state, bit for bit."""
    runs = []
    for on in (False, True):
        e, batches = _batch_engine()
        ctx = contextlib.nullcontext()
        if on:
            ctx = (trace.enabled() if traced == "enabled"
                   else profile(activities=[ProfilerActivity.CPU]))
        with ctx:
            out = _batches_until_reprep(e, batches)
            out.append(e.query(batches[-1]))
        runs.append((out, state_to_numpy(e.state), e.cache,
                     e.queries_made_in_partition,
                     e._rng.bit_generator.state))
    (a0, s0, c0, u0, g0), (a1, s1, c1, u1, g1) = runs
    assert len(a0) == len(a1) and all(np.array_equal(x, y)
                                      for x, y in zip(a0, a1))
    assert s0.keys() == s1.keys()
    for key in s0:
        assert np.array_equal(s0[key], s1[key]), key
    assert c0.keys() == c1.keys() and all(np.array_equal(c0[k], c1[k])
                                          for k in c0)
    assert u0 == u1 and g0 == g1


# -- the graph build (graph/build.py::build_graph) ---------------------------

BUILD_N, BUILD_D, BUILD_M = 1024, 16, 8


@pytest.fixture(scope="module")
def builds():
    """A small CPU build (two descent rounds, the quality gate on), once
    untraced and once inside enabled(): each graph and stats, and the
    traced build's recording."""
    from pacmann_tpu_torch.graph.build import build_graph

    rng = np.random.default_rng(31)
    basis = rng.standard_normal((4, BUILD_D))
    z = rng.standard_normal((BUILD_N, 4))
    v = np.clip(np.rint(128 + 32 * z @ basis / 2), 0, 255).astype(np.uint8)
    out = []
    for on in (False, True):
        stats = {}
        with trace.enabled() if on else contextlib.nullcontext():
            graph = build_graph(v, BUILD_M, rounds=2, seed=4, device="cpu",
                                quality_gate=True, stats=stats)
        out.append((graph, stats))
    return v, out, trace.read()


def test_a_build_is_a_request_holding_one_span_per_stage(builds):
    """One span a stage, and a second "degree reg + fill" span for its
    host fill; a phase's seconds are those of its spans."""
    _, (_, (_, stats)), rec = builds
    whole = [s for s in rec.spans if s.name == "build"]
    assert len(whole) == 1
    b = whole[0]
    assert b.parent is None and b.request == b.id
    stages = [s for s in rec.spans if s is not b]
    phases = stats["phases"]
    assert set(phases) == {"bootstrap", "descent 0", "descent 1", "wide",
                           "ladder", "nav prune", "corridors",
                           "final prune", "degree reg + fill", "gate"}
    assert sorted(s.name for s in stages) == sorted(
        ["build." + name.replace(" ", "_") for name in phases]
        + ["build.degree_reg_+_fill"])
    seconds = {}
    for s in stages:
        assert s.parent == b.id and s.request == b.id
        assert b.start_ns <= s.start_ns <= s.end_ns <= b.end_ns
        name = s.name[len("build."):].replace("_", " ")
        seconds[name] = seconds.get(name, 0.0) + (s.end_ns - s.start_ns) * 1e-9
    assert seconds == phases
    assert stats["seconds"] >= sum(phases.values())


def test_a_traced_build_gives_the_untraced_graph(builds):
    v, ((g0, s0), (g1, s1)), _ = builds
    assert np.array_equal(g0, g1)
    assert s0["gate"] == s1["gate"] and set(s0["phases"]) == set(s1["phases"])
    assert g0.shape == (BUILD_N, BUILD_M)
    assert all(len(set(row)) == BUILD_M and i not in row
               for i, row in enumerate(g0.tolist()))


def _built_search(builds):
    """The fused search over the small build's graph (vector || neighbours
    rows), prepared from a fixed seed, and two queries."""
    v, ((graph, _), _), _ = builds
    vec = v.astype(np.float32)
    raw = np.concatenate([vec.view(np.uint32), graph.astype(np.uint32)],
                         axis=1)
    e = DevicePianoEngine(BUILD_N, 4 * (BUILD_D + BUILD_M), BUILD_M, raw, 8,
                          device="cpu")
    e.preprocessing(rng=np.random.default_rng(6))
    sids = np.random.default_rng(2).choice(BUILD_N, 32, replace=False)
    fs = FusedPrivateSearch(e, sids, vec[sids], graph[sids], dim=BUILD_D,
                            m=BUILD_M, n=BUILD_N)
    return fs, vec[[3, 700]] + 1


def test_fetch_counters_are_the_fetch_stats_increase(builds):
    """search.fetches_wanted, _kept and _served count what fetch_stats
    gains, search by search, across a refresh inside a search."""
    fs, q = _built_search(builds)
    per = (fs.engine.params.max_query_num - 2) // (
        2 * 2 * BUILD_M // fs.engine.config.partition_num)
    fs.fetch_stats[:] = [5, 4, 3]
    before = fs.fetch_stats.copy()
    with trace.enabled():
        _run(fs, q, max_step=per + 1)
        _run(fs, q)
    c = trace.read().counters
    assert fs.refreshes >= 1
    got = [c.get(name, 0) for name in ("search.fetches_wanted",
                                       "search.fetches_kept",
                                       "search.fetches_served")]
    assert got == (fs.fetch_stats - before).tolist()
    assert got[0] >= got[1] >= got[2] > 0


def test_a_traced_search_answers_as_an_untraced_one(builds):
    """Over the built graph: the same answers, fetch accounting and state
    with tracing on and off."""
    out = []
    for on in (False, True):
        fs, q = _built_search(builds)
        with trace.enabled() if on else contextlib.nullcontext():
            ans = _run(fs, q)
        out.append((ans, fs.fetch_stats.copy(), _state(fs)))
    (a0, f0, s0), (a1, f1, s1) = out
    assert np.array_equal(a0, a1) and (a0 >= 0).all()
    assert np.array_equal(f0, f1) and s0.keys() == s1.keys()
    for key in s0:
        assert np.array_equal(s0[key], s1[key]), key


# -- the exact scan and the plaintext search (graph/recall.py, graph/beam.py)

def _u8_data(n, q, d=16, seed=12):
    rng = np.random.default_rng(seed)
    vectors = rng.integers(0, 256, size=(n, d)).astype(np.float32)
    queries = rng.integers(0, 256, size=(q, d)).astype(np.float32)
    return torch.from_numpy(vectors), torch.from_numpy(queries)


def _tree(rec, request):
    """The recording's one request span `request` and the other spans,
    each checked to sit inside it as a child of it."""
    roots = [s for s in rec.spans if s.name == request]
    assert len(roots) == 1
    r = roots[0]
    assert r.parent is None and r.request == r.id
    rest = [s for s in rec.spans if s is not r]
    for s in rest:
        assert s.parent == r.id and s.request == r.id
        assert r.start_ns <= s.start_ns <= s.end_ns <= r.end_ns
    return rest


def test_a_traced_knn_search_is_one_request_tree():
    """knn_search inside enabled(): the untraced answers; one "knn"
    request holding a "knn.distance" and a "knn.select" span a tile, in
    turn; counters knn.queries and knn.tiles (2 query blocks x 5 point
    blocks)."""
    from pacmann_tpu_torch.graph.recall import Q_BLOCK, knn_search

    v, q = _u8_data(4500, Q_BLOCK + 76)
    want = knn_search(v, q, 7, p_block=1024)
    with trace.enabled():
        got = knn_search(v, q, 7, p_block=1024)
    assert all(torch.equal(a, b) for a, b in zip(want, got))
    rec = trace.read()
    tiles = 2 * 5
    rest = _tree(rec, "knn")
    assert [s.name for s in sorted(rest, key=lambda s: s.start_ns)] == \
        ["knn.distance", "knn.select"] * tiles
    assert rec.counters == {"knn.queries": Q_BLOCK + 76, "knn.tiles": tiles}


@pytest.mark.parametrize("benchmarking", (False, True))
def test_a_traced_plaintext_search_is_one_request_tree(benchmarking):
    """PlaintextEngine.search inside enabled(): the untraced answers; one
    "ann" request holding "ann.seed", an "ann.step" a step and
    "ann.finish", in turn; counters ann.queries and ann.steps."""
    from pacmann_tpu_torch.graph.beam import PlaintextEngine

    v, q = _u8_data(2048, 9)
    graph = np.random.default_rng(4).integers(0, 2048, size=(2048, 8))
    eng = PlaintextEngine(v, graph, device="cpu")
    kw = dict(k=5, max_step=6, parallel=2, seed=3,
              benchmarking=benchmarking)
    want = eng.search(q, **kw)
    with trace.enabled():
        got = eng.search(q, **kw)
    assert all(np.array_equal(a, b) for a, b in zip(want, got))
    rec = trace.read()
    rest = _tree(rec, "ann")
    assert [s.name for s in sorted(rest, key=lambda s: s.start_ns)] == \
        ["ann.seed"] + ["ann.step"] * 6 + ["ann.finish"]
    assert rec.counters == {"ann.queries": 9, "ann.steps": 6}


def test_the_corridor_search_and_an_untraced_search_record_nothing():
    """search_paths_all (the build's corridor stage) and a search with
    traced=False (the build's quality gate) open no span and count
    nothing, so a traced build records its own spans alone."""
    from pacmann_tpu_torch.graph.beam import PlaintextEngine, search_paths_all

    v, q = _u8_data(512, 3)
    graph = torch.from_numpy(
        np.random.default_rng(5).integers(0, 512, size=(512, 8))).int()
    with trace.enabled():
        search_paths_all(v, graph, torch.arange(16), n=512, m=8, max_step=4,
                         parallel=2, block=128, seed=2)
        PlaintextEngine(v, graph, device="cpu").search(q, 5, 4, 2,
                                                       traced=False)
    assert trace.read() == ([], {})
