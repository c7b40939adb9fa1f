"""The torch SimpleBatchPianoPIR against the JAX one (tests/test_batch_pir.py's
cases at their sizes): the same raw DB and numpy seeds give bit-identical
answers, per-partition client state and budget counters after
preprocessing and after every batch, including the lossy FCFS contract
(overflow dropped to zeros), dummy padding, the non-divisible last
partition and the automatic re-prep. The port runs on the CPU here (plain
versions of kernels K1 and K7c)."""

import dataclasses
import secrets

import numpy as np
import pytest
import torch

from pacmann_tpu.pir.batch import SimpleBatchPianoPIR as JaxBatch
from pacmann_tpu_torch.pir.batch import SimpleBatchPianoPIR

torch.set_num_threads(1)


def _pair(n=8192, entry_bytes=32, batch=32, fail=20, db_seed=0,
          prep_seed=100):
    raw = np.random.default_rng(db_seed).integers(
        0, 2**32, size=(n, entry_bytes // 4), dtype=np.uint32)
    ref = JaxBatch(n, entry_bytes, batch, raw, fail)
    got = SimpleBatchPianoPIR(n, entry_bytes, batch, raw, fail, device="cpu")
    ref.preprocessing(rng=np.random.default_rng(prep_seed))
    got.preprocessing(rng=np.random.default_rng(prep_seed))
    return raw, ref, got


def _assert_same(ref, got):
    """Every partition's ClientState, cache and draw position, and the
    batch counters."""
    assert len(got.sub_pir) == len(ref.sub_pir)
    for r, g in zip(ref.sub_pir, got.sub_pir):
        for f in dataclasses.fields(r.client.state):
            want = getattr(r.client.state, f.name)
            have = getattr(g.client.state, f.name)
            assert np.array_equal(have, want), f.name
            if f.name != "finished":
                assert have.dtype == want.dtype, f.name
        assert sorted(g.client.cache) == sorted(r.client.cache)
        assert all(np.array_equal(g.client.cache[i], r.client.cache[i])
                   for i in r.client.cache)
        assert (g.client._rng.bit_generator.state
                == r.client._rng.bit_generator.state)
    for name in ("finished_batch_num", "queries_made_in_partition",
                 "support_batch_num", "comm_cost_per_batch_offline"):
        assert getattr(got, name) == getattr(ref, name), name


def _query(ref, got, ids):
    want = ref.query(ids)
    have = got.query(ids)
    assert have.dtype == want.dtype and np.array_equal(have, want)
    _assert_same(ref, got)
    return have


def test_prep_and_accounting_identical():
    _, ref, got = _pair()
    _assert_same(ref, got)
    assert got.local_storage_size() == ref.local_storage_size()
    assert got.extra_storage_size() == ref.extra_storage_size()
    assert got.comm_cost_per_batch_online() == ref.comm_cost_per_batch_online()
    assert dataclasses.astuple(got.config) == dataclasses.astuple(ref.config)


def test_batch_spread_queries_identical():
    raw, ref, got = _pair(db_seed=20)
    c = got.config
    rng = np.random.default_rng(20)
    ids = [int(i * c.partition_size + rng.integers(0, c.partition_size))
           for i in range(c.partition_num)] * 2
    out = _query(ref, got, ids)
    for r, idx in enumerate(ids):
        assert np.array_equal(out[r], raw[idx]), (r, idx)


def test_batch_overflow_dropped_to_zeros_identical():
    raw, ref, got = _pair(db_seed=21)
    ids = list(range(100, 132))          # all in partition 0, distinct
    out = _query(ref, got, ids)
    answered = 32 // got.config.partition_num    # FCFS (batch-pir.go:194-216)
    for r in range(answered):
        assert np.array_equal(out[r], raw[ids[r]])
    assert not out[answered:].any()


def test_batch_short_batch_pads_with_dummies_identical():
    raw, ref, got = _pair(db_seed=22)
    c = got.config
    ids = [int(i * c.partition_size + 7) for i in range(c.partition_num)]
    out = _query(ref, got, ids)
    assert np.array_equal(out, raw[ids])


def test_batch_repeated_ids_use_cache_identical():
    raw, ref, got = _pair(db_seed=23)
    ids = [5, 5, 600, 600] * 8
    _query(ref, got, ids)
    out = _query(ref, got, ids)
    assert np.array_equal(out[:4], raw[ids[:4]])


def test_batch_nondivisible_db_identical():
    """n = 8,000 over 16 partitions: the last partition is short."""
    raw, ref, got = _pair(n=8000, db_seed=24)
    c = got.config
    rng = np.random.default_rng(24)
    ids = [int(i * c.partition_size + rng.integers(0, min(
        c.partition_size, 8000 - i * c.partition_size)))
        for i in range(c.partition_num)] * 2
    out = _query(ref, got, ids)
    assert np.array_equal(out, raw[ids])


def test_batch_auto_reprep_budget_identical(monkeypatch):
    """Enough uniform batches to trip the re-prep (batch-pir.go:239-245)
    at least once, both engines in step throughout; an automatic re-prep
    draws its keys from secrets.randbits in both packages, pinned here."""
    monkeypatch.setattr(secrets, "randbits", lambda k: 4242)
    raw, ref, got = _pair(n=2048, db_seed=25, prep_seed=101)
    rng = np.random.default_rng(25)
    max_q = got.sub_pir[0].params.max_query_num
    ok, reprepped = 0, False
    for _ in range(max_q):
        ids = [int(rng.integers(0, 2048)) for _ in range(32)]
        before = got.queries_made_in_partition
        out = _query(ref, got, ids)
        reprepped |= got.queries_made_in_partition < before
        ok += sum(np.array_equal(out[r], raw[i]) for r, i in enumerate(ids))
    assert reprepped
    assert ok > max_q * 32 * 0.65      # the lossy FCFS bound, ~73 %


def test_dummy_preprocessing_identical():
    raw = np.random.default_rng(26).integers(0, 2**32, size=(2048, 8),
                                             dtype=np.uint32)
    ref = JaxBatch(2048, 32, 32, raw, 20)
    got = SimpleBatchPianoPIR(2048, 32, 32, raw, 20, device="cpu")
    ref.dummy_preprocessing(rng=np.random.default_rng(27))
    got.dummy_preprocessing(rng=np.random.default_rng(27))
    _assert_same(ref, got)


def test_default_device_is_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    raw = np.zeros((2048, 8), np.uint32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SimpleBatchPianoPIR(2048, 32, 32, raw, 20)
