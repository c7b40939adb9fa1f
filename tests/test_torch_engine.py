"""The torch FusedBatchPianoPIR against the JAX one (tests/test_engine.py's
cases at their sizes): the same raw DB and numpy seeds give bit-identical
answers, per-partition client state and budget counters after
preprocessing and after every batch. The port's prep is one K1 launch
and one K7b launch on the (S, P, C*k, 128) DB with local offsets and the
skip mask, its batch one K2 scan; here on the CPU, their plain
versions."""

import dataclasses
import secrets

import numpy as np
import pytest
import torch

from pacmann_tpu.ops.xor_scan import xor_scan_xla
from pacmann_tpu.pir.engine import FusedBatchPianoPIR as JaxFused
from pacmann_tpu_torch import native_lib
from pacmann_tpu_torch.ops import aes, attic, xor_scan
from pacmann_tpu_torch.pir.batch import SimpleBatchPianoPIR
from pacmann_tpu_torch.pir.engine import FusedBatchPianoPIR

torch.set_num_threads(1)


def _pair(n=8192, entry_bytes=32, batch=32, fail=20, db_seed=0,
          prep_seed=100):
    raw = np.random.default_rng(db_seed).integers(
        0, 2**32, size=(n, entry_bytes // 4), dtype=np.uint32)
    ref = JaxFused(n, entry_bytes, batch, raw, fail, device=False)
    got = FusedBatchPianoPIR(n, entry_bytes, batch, raw, fail, device="cpu")
    ref.preprocessing(rng=np.random.default_rng(prep_seed))
    got.preprocessing(rng=np.random.default_rng(prep_seed))
    return raw, ref, got


def _assert_same(ref, got):
    """Every partition's ClientState, cache and draw position, and the
    batch counters."""
    assert len(got.clients) == len(ref.clients)
    for r, g in zip(ref.clients, got.clients):
        for f in dataclasses.fields(r.state):
            want, have = getattr(r.state, f.name), getattr(g.state, f.name)
            assert np.array_equal(have, want), f.name
            if f.name != "finished":
                assert have.dtype == want.dtype, f.name
        assert sorted(g.cache) == sorted(r.cache)
        assert all(np.array_equal(g.cache[i], r.cache[i]) for i in r.cache)
        assert g._rng.bit_generator.state == r._rng.bit_generator.state
    for name in ("finished_batch_num", "queries_made_in_partition",
                 "support_batch_num", "comm_cost_per_batch_offline"):
        assert getattr(got, name) == getattr(ref, name), name


def _query(ref, got, ids):
    want = ref.query(ids)
    have = got.query(ids)
    assert have.dtype == want.dtype and np.array_equal(have, want)
    _assert_same(ref, got)
    return have


def test_fused_db_and_prep_identical():
    """The (S, P, C*k, 128) DB and its flat view equal the JAX engine's
    db_f; the prep state equals its."""
    _, ref, got = _pair()
    _assert_same(ref, got)
    want = np.asarray(ref.db)
    assert got.db.data_ptr() == got.db4.data_ptr()
    assert np.array_equal(got.db.numpy().view(np.uint32), want)
    assert np.array_equal(got.db4.reshape(want.shape).numpy().view(np.uint32),
                          want)
    assert np.array_equal(got.raw, ref.raw)
    assert got.local_storage_size() == ref.local_storage_size()
    assert got.extra_storage_size() == ref.extra_storage_size()
    assert got.comm_cost_per_batch_online() == ref.comm_cost_per_batch_online()


def test_fused_spread_queries_identical():
    raw, ref, got = _pair(db_seed=30)
    c = got.config
    rng = np.random.default_rng(30)
    ids = [int(i * c.partition_size + rng.integers(0, c.partition_size))
           for i in range(c.partition_num)] * 2
    out = _query(ref, got, ids)
    for r, idx in enumerate(ids):
        assert np.array_equal(out[r], raw[idx]), (r, idx)


def test_fused_overflow_dropped_to_zeros_identical():
    raw, ref, got = _pair(db_seed=31)
    ids = list(range(32))                # all in partition 0, distinct
    out = _query(ref, got, ids)
    answered = 32 // got.config.partition_num
    for r in range(answered):
        assert np.array_equal(out[r], raw[ids[r]])
    assert not out[answered:].any()


def test_fused_duplicates_and_cache_identical():
    """In-flight duplicates are sent as dummies, and a cached id is served
    by the client while a dummy row keeps the access pattern."""
    raw, ref, got = _pair(db_seed=32)
    ids = [40, 40, 700, 700] * 8
    _query(ref, got, ids)
    out = _query(ref, got, ids)
    assert np.array_equal(out[:4], raw[ids[:4]])


def test_fused_nondivisible_db_padding_identical():
    """Non-divisible n: the fused engine zero-pads the last partition."""
    n = 8000
    raw, ref, got = _pair(n=n, db_seed=33)
    c = got.config
    rng = np.random.default_rng(33)
    ids = [int(i * c.partition_size + rng.integers(0, min(
        c.partition_size, n - i * c.partition_size)))
        for i in range(c.partition_num)]
    out = _query(ref, got, ids)
    assert np.array_equal(out, raw[ids])


def test_fused_budget_reprep_identical(monkeypatch):
    """The whole budget of uniform batches, the re-prep included, both
    engines in step; the re-prep's keys come from secrets.randbits in both
    packages, pinned here."""
    monkeypatch.setattr(secrets, "randbits", lambda k: 777)
    raw, ref, got = _pair(n=2048, db_seed=34, prep_seed=101)
    rng = np.random.default_rng(34)
    max_q = got.params.max_query_num
    ok, reprepped = 0, False
    for _ in range(max_q):
        ids = [int(rng.integers(0, 2048)) for _ in range(32)]
        before = got.queries_made_in_partition
        out = _query(ref, got, ids)
        reprepped |= got.queries_made_in_partition < before
        ok += sum(np.array_equal(out[r], raw[i]) for r, i in enumerate(ids))
    assert reprepped
    assert ok > max_q * 32 * 0.65      # the lossy FCFS bound, ~73 %


def test_fused_short_batch_and_empty_batch_identical():
    """Fewer ids than partitions: quota 0, no server scan, zeros."""
    raw, ref, got = _pair(db_seed=35)
    out = _query(ref, got, [1, 2, 3])
    assert out.shape == (3, 8) and not out.any()
    c = got.config
    ids = [int(i * c.partition_size + 9) for i in range(c.partition_num)]
    assert np.array_equal(_query(ref, got, ids), raw[ids])


def test_fused_dummy_preprocessing_identical():
    raw = np.random.default_rng(36).integers(0, 2**32, size=(2048, 8),
                                             dtype=np.uint32)
    ref = JaxFused(2048, 32, 32, raw, 20, device=False)
    got = FusedBatchPianoPIR(2048, 32, 32, raw, 20, device="cpu")
    ref.dummy_preprocessing(rng=np.random.default_rng(37))
    got.dummy_preprocessing(rng=np.random.default_rng(37))
    _assert_same(ref, got)


def test_fused_matches_simple_interface():
    """Cost accessors agree with the per-partition implementation."""
    raw = np.random.default_rng(38).integers(0, 2**32, size=(8192, 8),
                                             dtype=np.uint32)
    fused = FusedBatchPianoPIR(8192, 32, 32, raw, 20, device="cpu")
    simple = SimpleBatchPianoPIR(8192, 32, 32, raw, 20, device="cpu")
    fused.preprocessing(rng=np.random.default_rng(1))
    simple.preprocessing(rng=np.random.default_rng(1))
    assert fused.local_storage_size() == simple.local_storage_size()
    assert (fused.comm_cost_per_batch_online()
            == simple.comm_cost_per_batch_online())
    assert fused.support_batch_num == simple.support_batch_num
    assert (fused.comm_cost_per_batch_offline
            == simple.comm_cost_per_batch_offline)
    ids = [int(i) for i in np.random.default_rng(39).integers(0, 8192, 32)]
    f_out, s_out = fused.query(ids), simple.query(ids)
    for r, idx in enumerate(ids):
        for out in (f_out, s_out):
            assert not out[r].any() or np.array_equal(out[r], raw[idx])


@pytest.mark.parametrize("k", [1, 2])
def test_k7b_local_view_matches_xor_scan_xla_global(k):
    """K7b's plain version on the (S, P, C*k, 128) view with local offsets
    (P, T, S) and the mask equals the JAX xor_scan_xla on the flat
    (S, P*C*k, 128) DB with global offsets p*C + o."""
    S, P, C, T = 6, 3, 16, 40
    rng = np.random.default_rng(40 + k)
    flat = rng.integers(0, 2**32, size=(S, P * C * k, 128), dtype=np.uint32)
    local = rng.integers(0, C, size=(P, T, S), dtype=np.uint32)
    skip = rng.random((P, T, S)) < 0.3
    skip[:, :2] = True                           # rows that skip every chunk
    glob = local + (np.arange(P, dtype=np.uint32) * C)[:, None, None]
    want = np.asarray(xor_scan_xla(flat, glob.reshape(P * T, S),
                                   skip.reshape(P * T, S), k))
    view = torch.from_numpy(flat.view(np.int32)).view(S, P, C * k, 128)
    got = attic.xor_hintgen_pallas(view, local, skip, k, device="cpu")
    assert np.array_equal(got.numpy().view(np.uint32).reshape(want.shape),
                          want)


def test_fused_prep_launches_k1_once_k7b_once_and_k2_per_batch(monkeypatch):
    """The engine's passes go through the dispatchers of K1, K7b and K2:
    prep evaluates every partition's table in one K1 call and scans in
    one K7b call (staged form where hintgen_form picks it), and a batch
    is one K2 call on (P, quota, S) offsets (row form). The host tier,
    which takes the CPU's passes where native_lib is available, is turned
    off."""
    monkeypatch.setattr(native_lib, "available", lambda: False)
    calls = []
    k1_plain = aes.prf_tables_plain
    k2_plain = xor_scan.xor_gather_plain

    def k1(rk, T, S, mask):
        calls.append(("K1", rk.shape[0]))
        return k1_plain(rk, T, S, mask)

    def k7b(db4, off, skip, k):
        S, P, CK, _ = db4.shape
        calls.append(("K7b", attic.hintgen_form(P, off.shape[1], S, CK // k,
                                                k), tuple(off.shape)))
        # K7b's plain version gathers through K2's: not counted as a K2 call
        return k2_plain(db4, torch.where(skip, -1, off), k).reshape(
            P, off.shape[1], k, 128)

    def k2(db4, off, k):
        S, P, CK, _ = db4.shape
        calls.append(("K2", xor_scan.gather_form(P, off.shape[1], S, CK // k,
                                                 k), tuple(off.shape)))
        return k2_plain(db4, off, k)

    monkeypatch.setattr(aes, "prf_tables_plain", k1)
    monkeypatch.setattr(attic, "xor_hintgen_pallas_plain", k7b)
    monkeypatch.setattr(xor_scan, "xor_gather_plain", k2)
    raw = np.random.default_rng(41).integers(0, 2**32, size=(16384, 8),
                                             dtype=np.uint32)
    got = FusedBatchPianoPIR(16384, 32, 32, raw, 8, device="cpu")
    got.preprocessing(rng=np.random.default_rng(42))
    p, P = got.params, got.config.partition_num
    T = p.primary_hint_num + p.set_size * p.max_query_per_chunk
    assert T >= 16 * p.chunk_size
    assert calls == [("K1", P), ("K7b", "staged", (P, T, p.set_size))]
    calls.clear()
    got.query([int(i) for i in range(0, 16384, 512)])
    assert calls == [("K2", "row", (P, 2, p.set_size))]


def test_default_device_is_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    raw = np.zeros((2048, 8), np.uint32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FusedBatchPianoPIR(2048, 32, 32, raw, 20)
