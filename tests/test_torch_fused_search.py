"""The torch FusedPrivateSearch against the JAX one. Vectors are
integer-valued, so every f32 distance is exact and both packages must
agree bit for bit: answer ids, reach steps, fetch counters, budget
accounting and the PIR state. The JAX PRNG draws of each search
(_draw_step_randoms) are handed to the port as step_randoms."""

import jax
import numpy as np
import pytest
import torch

from pacmann_tpu.pir.device_engine import DevicePianoEngine as JaxEngine
from pacmann_tpu.private.fused_search import FusedPrivateSearch as JaxSearch
from pacmann_tpu.private.fused_search import _draw_step_randoms
from pacmann_tpu.private.oracle import pack_vertex_db
from pacmann_tpu_torch.pir.convert import state_to_numpy
from pacmann_tpu_torch.pir.device_engine import DevicePianoEngine as TorchEngine
from pacmann_tpu_torch.private.fused_search import (
    FusedPrivateSearch as TorchSearch)

# Tests run in several worker processes at once; torch's default of one
# intra-op thread per core oversubscribes the machine (measured about
# 4x slower for this file set), and these tensors are small.
torch.set_num_threads(1)


def _pair(seed, n=1024, d=8, m=8, fail=8, prep_seed=99):
    rng = np.random.default_rng(seed)
    vectors = rng.integers(0, 8, size=(n, d)).astype(np.float32)
    graph = rng.integers(0, n, size=(n, m))
    raw = pack_vertex_db(vectors, graph)
    sids = rng.choice(n, 32, replace=False)
    out = []
    for Engine, Search, kw in ((JaxEngine, JaxSearch, {}),
                               (TorchEngine, TorchSearch, {"device": "cpu"})):
        e = Engine(n, 4 * (d + m), m, raw, fail, **kw)
        e.preprocessing(rng=np.random.default_rng(prep_seed))
        out.append(Search(e, sids, vectors[sids], graph[sids],
                          dim=d, m=m, n=n))
    return out[0], out[1], rng


def _randoms(fs, Qn, max_step, parallel, seed):
    """The JAX search's own per-step draws for `seed`."""
    e = fs.engine
    P = e.config.partition_num
    keys = jax.random.split(jax.random.PRNGKey(seed), max_step)
    rand_all, rnd_all = _draw_step_randoms(
        keys, Qn=Qn, parallel=parallel, m=fs.m, n=fs.n,
        quota=Qn * parallel * fs.m // P, P=P, S=e.params.set_size,
        C=e.params.chunk_size)
    return np.asarray(rand_all), np.asarray(rnd_all)


def _search_both(ref, got, queries, k, max_step, parallel, seed):
    ids_r, st_r = ref.search(queries, k=k, max_step=max_step,
                             parallel=parallel, seed=seed, return_steps=True)
    ids_g, st_g = got.search(
        queries, k=k, max_step=max_step, parallel=parallel,
        step_randoms=_randoms(ref, queries.shape[0], max_step, parallel,
                              seed),
        return_steps=True)
    assert np.array_equal(ids_g, ids_r)
    assert np.array_equal(st_g, st_r)
    assert np.array_equal(got.fetch_stats, ref.fetch_stats)
    assert got.refreshes == ref.refreshes
    e_r, e_g = ref.engine, got.engine
    assert e_g.queries_made_in_partition == e_r.queries_made_in_partition
    assert e_g.finished_batch_num == e_r.finished_batch_num
    want = {k: np.asarray(v).astype(np.uint32) for k, v in e_r.state.items()}
    have = state_to_numpy(e_g.state)
    for key, v in want.items():
        assert np.array_equal(have[key], v), key
    return ids_g


@pytest.mark.parametrize("Qn,parallel,max_step", [(1, 3, 6), (2, 2, 5)])
def test_search_matches_reference(Qn, parallel, max_step):
    ref, got, rng = _pair(31)
    queries = rng.integers(0, 8, size=(Qn, 8)).astype(np.float32)
    ids = _search_both(ref, got, queries, 5, max_step, parallel, seed=7)
    assert (ids >= 0).any()


def test_mid_group_refresh_and_leftover_match_reference():
    """A 12-step group that needs a mid-search refresh (quota 12 against a
    budget of 88), then searches that drain the leftover window: both
    packages refresh at the same points and stay identical."""
    ref, got, rng = _pair(46, prep_seed=5)
    ref.engine._rng = np.random.default_rng(7)
    got.engine._rng = np.random.default_rng(7)
    queries = rng.integers(0, 8, size=(2, 8)).astype(np.float32)
    assert got.segment_plan(12, 12) == ref.segment_plan(12, 12)
    _search_both(ref, got, queries, 5, 12, 3, seed=11)
    assert got.refreshes >= 1
    for i in range(3):
        q = rng.integers(0, 8, size=(2, 8)).astype(np.float32)
        assert got.segment_plan(4, 8, use_leftover=True) == \
            ref.segment_plan(4, 8, use_leftover=True)
        _search_both(ref, got, q, 5, 4, 2, seed=20 + i)
    assert got.fetch_success_rate() == ref.fetch_success_rate()


def test_ensure_budget_matches_reference():
    ref, got, _ = _pair(33)
    for fs in (ref, got):
        fs.engine.queries_made_in_partition = 60
        fs.ensure_budget(4, 2, 2, min_steps=4)
        fs.ensure_budget(4, 2, 2, min_steps=4)
    assert got.refreshes == ref.refreshes == 1
    assert got.engine.queries_made_in_partition == \
        ref.engine.queries_made_in_partition


def test_search_draws_its_own_randoms():
    """Without step_randoms the port draws from its torch.Generator: the
    search runs, answers are valid ids and the counters advance."""
    _, got, rng = _pair(12)
    queries = rng.integers(0, 8, size=(2, 8)).astype(np.float32)
    ids = got.search(queries, k=5, max_step=4, parallel=2)
    assert ids.shape == (2, 5)
    assert ((ids >= -1) & (ids < 1024)).all() and (ids >= 0).any()
    assert got.fetch_stats[0] > 0 and got.engine.queries_made_in_partition > 0


def test_dummy_refresh_matches_reference():
    """refresh_dummy (the driver's benchmarking mode): _refresh() takes the
    engine's dummy_preprocessing, as the JAX search does: the all-zero hint
    state, no draw from the engine's generator; then a search on it gives
    the JAX answers, steps, fetch counters and state."""
    ref, got, rng = _pair(52)
    for fs in (ref, got):
        fs.refresh_dummy = True
        fs.engine._rng = np.random.default_rng(3)
        fs._refresh()
    assert got.refreshes == ref.refreshes == 1
    assert (got.engine._rng.bit_generator.state
            == ref.engine._rng.bit_generator.state
            == np.random.default_rng(3).bit_generator.state)
    want = {k: np.asarray(v).astype(np.uint32)
            for k, v in ref.engine.state.items()}
    have = state_to_numpy(got.engine.state)
    for key, v in want.items():
        assert np.array_equal(have[key], v), key
    assert not have["primary_parity"].any() and not have["table"].any()
    queries = rng.integers(0, 8, size=(2, 8)).astype(np.float32)
    _search_both(ref, got, queries, 5, 4, 2, seed=9)


def test_budget_left_matches_reference():
    """budget_left() equals JAX's at a fresh window, after a search inside
    it, and after a search that crosses a refresh."""
    ref, got, rng = _pair(46, prep_seed=5)
    ref.engine._rng = np.random.default_rng(7)
    got.engine._rng = np.random.default_rng(7)
    max_q = got.engine.params.max_query_num
    assert got.budget_left() == ref.budget_left() == max_q
    queries = rng.integers(0, 8, size=(2, 8)).astype(np.float32)
    _search_both(ref, got, queries, 5, 3, 2, seed=3)
    assert got.refreshes == 0
    assert got.budget_left() == ref.budget_left() < max_q
    _search_both(ref, got, queries, 5, 12, 3, seed=11)
    assert got.refreshes >= 1
    assert got.budget_left() == ref.budget_left()
