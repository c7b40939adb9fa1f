"""The torch DevicePianoEngine against the JAX one: the same raw DB and the
same numpy seeds give bit-identical state after preprocessing and after
every batch, identical answers and identical budget accounting. The port
runs on the CPU here (plain versions of kernels K1 and K2)."""

import numpy as np
import pytest
import torch

from pacmann_tpu.pir.device_engine import DevicePianoEngine as JaxEngine
from pacmann_tpu_torch.pir import device_engine as tde
from pacmann_tpu_torch.pir.convert import (
    db_from_numpy, state_from_numpy, state_to_numpy)
from pacmann_tpu_torch.pir.device_engine import STATE_KEYS
from pacmann_tpu_torch.pir.device_engine import DevicePianoEngine as TorchEngine

# Tests run in several worker processes at once; torch's default of one
# intra-op thread per core oversubscribes the machine (measured about
# 4x slower for this file set), and these tensors are small.
torch.set_num_threads(1)


def _pair(n=8192, entry_bytes=32, batch=32, fail=20, seed=0, prep_seed=7):
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 2**32, size=(n, entry_bytes // 4), dtype=np.uint32)
    ref = JaxEngine(n, entry_bytes, batch, raw, fail)
    got = TorchEngine(n, entry_bytes, batch, raw, fail, device="cpu")
    ref.preprocessing(rng=np.random.default_rng(prep_seed))
    got.preprocessing(rng=np.random.default_rng(prep_seed))
    return raw, ref, got


def _assert_same_state(ref, got):
    want = {k: np.asarray(v).astype(np.uint32) for k, v in ref.state.items()}
    have = state_to_numpy(got.state)
    assert set(have) == set(STATE_KEYS)
    for key in STATE_KEYS:
        assert have[key].shape == want[key].shape, key
        assert np.array_equal(have[key], want[key]), key
    assert got.queries_made_in_partition == ref.queries_made_in_partition
    assert got.finished_batch_num == ref.finished_batch_num


def test_pack_db_matches_reference():
    for n in (8192, 8000):
        raw = np.random.default_rng(n).integers(
            0, 2**32, size=(n, 8), dtype=np.uint32)
        ref = JaxEngine(n, 32, 32, raw, 20)
        got = TorchEngine(n, 32, 32, raw, 20, device="cpu")
        assert np.array_equal(got.db.numpy().view(np.uint32),
                              np.asarray(ref.db)), n


def test_prep_state_identical():
    _, ref, got = _pair()
    _assert_same_state(ref, got)
    assert got.support_batch_num == ref.support_batch_num
    assert got.comm_cost_per_batch_offline == ref.comm_cost_per_batch_offline
    assert got.local_storage_size() == ref.local_storage_size()
    assert got.comm_cost_per_batch_online() == ref.comm_cost_per_batch_online()


@pytest.mark.parametrize("retries", [0, 1])
def test_query_batches_identical(retries):
    """Spread, duplicate and overflow batches in sequence: answers, state
    and budget accounting match after each one."""
    raw, ref, got = _pair(seed=1, prep_seed=11)
    c = ref.config
    rng = np.random.default_rng(2)
    spread = [int(i * c.partition_size + rng.integers(0, c.partition_size))
              for i in range(c.partition_num)] * 2
    duplicate = [7] * 32
    overflow = list(range(100, 132))        # all in partition 0
    for ids in (spread, duplicate, overflow):
        out_ref = ref.query(ids, retries=retries)
        out_got = got.query(ids, retries=retries)
        assert np.array_equal(out_got, out_ref)
        _assert_same_state(ref, got)
    # the served rows are the raw rows (the port is exact, not just equal)
    for r, idx in enumerate(spread):
        assert np.array_equal(got.cache[idx], raw[idx]), r


def test_wide_entries_identical():
    """3,968 B entries (k = 8 rows of 128 words: a 960-dimensional vector
    and 32 neighbour ids): state after prep and the answers of two batches
    equal the JAX engine's, and the answers are the raw rows."""
    raw, ref, got = _pair(n=2048, entry_bytes=3968, seed=14, prep_seed=15)
    assert got.k == 8
    _assert_same_state(ref, got)
    rng = np.random.default_rng(16)
    for _ in range(2):
        ids = [int(i) for i in rng.integers(0, 2048, 32)]
        out = got.query(ids)
        assert np.array_equal(out, ref.query(ids))
        _assert_same_state(ref, got)
        hits = [r for r in range(32) if out[r].any()]
        assert len(hits) >= 30
        for r in hits:
            assert np.array_equal(out[r], raw[ids[r]])


def test_budget_exhaustion_reprep_identical():
    """Random batches until the window is spent: both engines re-prep on
    the same batch and keep identical state through it."""
    raw, ref, got = _pair(n=2048, seed=3, prep_seed=101)
    rng = np.random.default_rng(4)
    preps = 0
    for _ in range(40):
        ids = [int(i) for i in rng.integers(0, 2048, 32)]
        before = ref.queries_made_in_partition
        out_ref = ref.query(ids)
        out_got = got.query(ids)
        assert np.array_equal(out_got, out_ref)
        _assert_same_state(ref, got)
        preps += ref.queries_made_in_partition < before
    assert preps >= 1


def test_state_from_numpy_answers_next_batch():
    """A JAX-prepped state and DB loaded into the port answer the next
    batch exactly as the JAX engine does."""
    import jax

    raw, ref, _ = _pair(seed=5, prep_seed=13)
    got = TorchEngine(8192, 32, 32, None, 20,
                      packed_db=db_from_numpy(np.asarray(ref.db), "cpu"))
    got.state = state_from_numpy(jax.device_get(ref.state), "cpu")
    ref._rng = np.random.default_rng(21)
    got._rng = np.random.default_rng(21)
    ids = [int(i) for i in np.random.default_rng(6).integers(0, 8192, 32)]
    assert np.array_equal(got.query(ids), ref.query(ids))
    _assert_same_state(ref, got)


@pytest.mark.parametrize("refresh", ["scatter", "dense"])
def test_contention_round_identical(refresh):
    """Worst-case slot contention (every round asks the same index in
    every partition) through one raw round, in both refresh forms: the
    owner fixpoint, oks, entries and refreshed state match the JAX
    engine's."""
    raw, ref, got = _pair(n=2048, seed=8, prep_seed=102)
    p = ref.params
    Q, P = 16, ref.config.partition_num
    idx_q = np.full((Q, P), 17, np.int32)
    rand_offs = (np.random.default_rng(9).integers(
        0, 2**32, size=(Q, P, p.set_size), dtype=np.uint64)
        & np.uint64(p.chunk_mask)).astype(np.uint32)
    ref.state, e_ref, ok_ref = ref._online(idx_q, rand_offs)
    e_got, ok_got = got._online(idx_q, rand_offs, refresh=refresh)
    assert np.array_equal(ok_got.numpy(), np.asarray(ok_ref))
    assert np.array_equal(e_got.numpy().view(np.uint32), np.asarray(e_ref))
    assert 5 <= int(ok_got.sum(dim=0).min()) < Q   # contention is real
    _assert_same_state(ref, got)


def test_state_to_numpy_is_a_snapshot():
    """The engine updates its state in place: a numpy snapshot must not
    follow later batches."""
    _, _, got = _pair(n=2048, seed=12)
    snap = state_to_numpy(got.state)
    got.state["prog"][0, 0] = 5
    assert snap["prog"][0, 0] == 0x7FFFFFFF


def test_dummy_preprocessing_shapes():
    _, ref, got = _pair(n=2048, seed=10)
    ref.dummy_preprocessing()
    got.dummy_preprocessing()
    _assert_same_state(ref, got)


def test_build_skip_matches_reference():
    from pacmann_tpu.pir.device_engine import _build_skip

    P, T, Hp, R, S = 3, 50, 20, 5, 6
    want = np.asarray(_build_skip(P, T, Hp, R, S)).reshape(P, T, S)
    got = tde._build_skip(P, T, Hp, R, S, torch.device("cpu"))
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("route,Q,want", [
    ("dense", 16, "dense"), ("scatter", 16, "scatter"),
    ("something", 16, "dense"), (None, 16, "scatter"), (None, 520, "dense")])
def test_refresh_route_follows_environment(monkeypatch, route, Q, want):
    """$PACMANN_REFRESH_ROUTE picks the refresh form as the JAX engine's
    _resolve_refresh does: "auto" (unset) by Q*P (Q = 520 over 16
    partitions is 8,320 rows, past the scatter's 8,192), "scatter" the
    scatter, any other value the dense rewrite. A spy shows the form the
    port ran; the state equals the JAX engine's under the same
    variable."""
    from pacmann_tpu.pir import device_engine as jde

    if route is None:
        monkeypatch.delenv("PACMANN_REFRESH_ROUTE", raising=False)
    else:
        monkeypatch.setenv("PACMANN_REFRESH_ROUTE", route)
    ran = []
    resolve = tde._resolve_refresh
    monkeypatch.setattr(tde, "_resolve_refresh",
                        lambda rows: ran.append(resolve(rows)) or ran[-1])
    raw, ref, got = _pair(n=2048, seed=14, prep_seed=104)
    p = ref.params
    P = ref.config.partition_num
    rng = np.random.default_rng(15)
    idx_q = rng.integers(0, ref.config.partition_size, size=(Q, P)).astype(
        np.int32)
    idx_q[8:] = -1                       # dummies past the first rounds
    rand_offs = (rng.integers(0, 2**32, size=(Q, P, p.set_size),
                              dtype=np.uint64)
                 & np.uint64(p.chunk_mask)).astype(np.uint32)
    ref.state, e_ref, ok_ref = ref._online(idx_q, rand_offs)
    e_got, ok_got = got._online(idx_q, rand_offs)
    # the JAX engine takes the scatter where its resolution is "scatter"
    # and the dense rewrite otherwise (device_engine.py:422)
    jax_form = jde._resolve_refresh(None, Q * P)
    assert ran == [want] == ["scatter" if jax_form == "scatter" else "dense"]
    assert np.array_equal(ok_got.numpy(), np.asarray(ok_ref))
    assert np.array_equal(e_got.numpy().view(np.uint32), np.asarray(e_ref))
    assert int(ok_got.sum()) > 0
    _assert_same_state(ref, got)
