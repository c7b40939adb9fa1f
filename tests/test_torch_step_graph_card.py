"""The fused search's step graphs (private/fused_search.py::StepGraphs) on
the card: a sequence of searches at a group of 1 and a group of 64, which
crosses real refreshes, on the graph path and on the eager path of two
engines with the same prep gives the same answers and steps, beam tensors,
fetch counters, engine state and rounds, bit for bit; every step is a
replay, each step shape is captured once, and a replayed step syncs the
host nowhere. Every test is marked `card` and skips without a CUDA
device. The file imports no JAX, so it runs on a machine that has none:

    python -m pytest --noconftest tests/test_torch_step_graph_card.py -m card
"""

import warnings

import numpy as np
import pytest
import torch

from pacmann_tpu_torch.pir.convert import state_to_numpy
from pacmann_tpu_torch.pir.device_engine import DevicePianoEngine
from pacmann_tpu_torch.private.fused_search import FusedPrivateSearch
from pacmann_tpu_torch.utils import trace

N, D, M, PARALLEL, K = 1 << 16, 128, 32, 3, 10
# (group, steps) of each search: a group of 1 spends its budget window in
# a few searches, a group of 64 refreshes before every step
SEQUENCE = [(1, 20)] * 3 + [(64, 3)] * 2 + [(1, 20)] * 4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _search(eager: bool):
    """A CUDA engine on seeded rows of 128 integer-valued float32 and 32
    neighbour ids, and its fused search; eager: every step set's graphs
    turned off, so run_steps takes its eager loop on the same buffers."""
    rng = np.random.default_rng(11)
    vectors = rng.integers(0, 8, size=(N, D)).astype(np.float32)
    graph = rng.integers(0, N, size=(N, M))
    raw = np.concatenate([vectors.view(np.uint32), graph.astype(np.uint32)],
                         axis=1)
    e = DevicePianoEngine(N, 4 * (D + M), 32, raw, 8, device="cuda")
    e.preprocessing(rng=np.random.default_rng(12))
    sids = rng.choice(N, 256, replace=False)
    fs = FusedPrivateSearch(e, sids, vectors[sids], graph[sids], dim=D, m=M,
                            n=N)
    if eager:
        made = fs._step_graphs

        def eager_set(*a):
            graphs = made(*a)
            graphs.graphed = False
            return graphs

        fs._step_graphs = eager_set
    rounds = []
    inner = e._round

    def recorded(idx_q, rnd_q, refresh=None):
        entries, oks = inner(idx_q, rnd_q, refresh)
        rounds.append((idx_q.clone(), oks.clone(), entries.clone()))
        return entries, oks

    e._round = recorded
    return fs, rounds


def _run(fs):
    out = []
    for i, (Qn, steps) in enumerate(SEQUENCE):
        q = np.random.default_rng(100 + i).integers(0, 8, (Qn, D)).astype(
            np.float32)
        fs.generator.manual_seed(2**31 + 3 * i)
        ids, reach = fs.search(q, k=K, max_step=steps, parallel=PARALLEL,
                               return_steps=True)
        graphs = fs.step_graphs[(Qn, PARALLEL, steps)]
        out.append((ids, reach, [t.clone() for t in graphs.beam]))
    return out


@pytest.mark.card
def test_graph_path_is_the_eager_path_bit_for_bit(card):
    """The graph path and the eager path of one sequence of searches
    leave the same answers, reach steps, beams, fetch counters, engine
    state and rounds; the graph path replays every step and captures each
    step shape's graphs once."""
    got, got_rounds = _search(eager=False)
    want, want_rounds = _search(eager=True)
    with trace.enabled():
        got_out = _run(got)
    counters = trace.read().counters
    want_out = _run(want)
    assert got.refreshes == want.refreshes and got.refreshes >= 3
    for (ids_a, st_a, beam_a), (ids_b, st_b, beam_b) in zip(got_out,
                                                            want_out):
        assert np.array_equal(ids_a, ids_b) and np.array_equal(st_a, st_b)
        for a, b in zip(beam_a, beam_b):
            assert torch.equal(a, b)
    assert (got_out[0][0] >= 0).any()
    assert np.array_equal(got.fetch_stats, want.fetch_stats)
    assert got.fetch_stats[0] > 0
    have, ref = state_to_numpy(got.engine.state), state_to_numpy(
        want.engine.state)
    for key, v in ref.items():
        assert np.array_equal(have[key], v), key
    assert len(got_rounds) == len(want_rounds) == sum(s for _, s in SEQUENCE)
    for a, b in zip(got_rounds, want_rounds):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    assert counters["step.graphed"] == counters["steps"] == len(got_rounds)
    shapes = {(Qn, steps) for Qn, steps in SEQUENCE}
    assert counters["step.captures"] == sum(2 * s for _, s in shapes)
    assert all(not g.graphed for g in want.step_graphs.values())


@pytest.mark.card
def test_a_replayed_step_syncs_the_host_nowhere(card):
    """Once a step shape's graphs are captured, run_steps over its steps
    on the graph path (the replays, the round between them, the copies of
    its outputs) raises no warning under set_sync_debug_mode("warn"),
    which a control sync does."""
    fs, _ = _search(eager=False)
    Qn, steps = SEQUENCE[0]
    fs.search(np.zeros((Qn, D), np.float32), k=K, max_step=steps,
              parallel=PARALLEL)
    graphs = fs.step_graphs[(Qn, PARALLEL, steps)]
    assert all(r is not None for r in graphs.routes)
    P = fs.engine.config.partition_num
    quota = Qn * PARALLEL * M // P
    rnd_all = torch.zeros((steps, quota, P, fs.engine.params.set_size),
                          dtype=torch.int32, device="cuda")
    torch.cuda.synchronize()
    seen = []
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = lambda *a, **kw: seen.append(a[0])
        torch.cuda.set_sync_debug_mode("warn")
        try:
            torch.zeros(1, device="cuda").item()            # control sync
            control = len(seen)
            fs.run_steps(graphs.beam, graphs.stats, graphs.queries,
                         graphs.rand_all, rnd_all, 0, 4, parallel=PARALLEL,
                         quota=quota, graphs=graphs)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert control >= 1
    assert len(seen) == control, seen[control:]
