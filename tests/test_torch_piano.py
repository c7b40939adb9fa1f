"""The torch PianoPIR against the JAX one (tests/test_pir.py's cases at
their sizes): the same raw DB and numpy seeds give bit-identical answers
and client state after preprocessing and after every query: offsets,
parities, tags, program points, replacements, histogram, finished, the
cache and the generator's position. The port runs on the CPU here (plain
versions of kernels K1 and K7c)."""

import dataclasses
import secrets

import numpy as np
import pytest
import torch

from pacmann_tpu.pir.piano import PianoPIR as JaxPIR
from pacmann_tpu.pir.piano import QueryError as JaxQueryError
from pacmann_tpu_torch import native_lib
from pacmann_tpu_torch.ops import aes, attic
from pacmann_tpu_torch.pir.piano import PianoPIR, QueryError

torch.set_num_threads(1)


def _rand_db(rng, n, entry_u32):
    return rng.integers(0, 2**32, size=(n, entry_u32), dtype=np.uint32)


def _pair(n, entry_bytes, fail, db_seed, prep_seed, **kw):
    raw = _rand_db(np.random.default_rng(db_seed), n, entry_bytes // 4)
    ref = JaxPIR(n, entry_bytes, raw, failure_prob_log2=fail, device=False)
    got = PianoPIR(n, entry_bytes, raw, failure_prob_log2=fail,
                   device="cpu", **kw)
    ref.preprocessing(rng=np.random.default_rng(prep_seed))
    got.preprocessing(rng=np.random.default_rng(prep_seed))
    return raw, ref, got


def assert_same_client(ref, got):
    """Every ClientState field, the cache and the draw position equal."""
    for f in dataclasses.fields(ref.state):
        want, have = getattr(ref.state, f.name), getattr(got.state, f.name)
        if f.name == "finished":
            assert have == want
            continue
        assert have.dtype == want.dtype and have.shape == want.shape, f.name
        assert np.array_equal(have, want), f.name
    assert got.key == ref.key
    assert sorted(got.cache) == sorted(ref.cache)
    assert all(np.array_equal(got.cache[i], ref.cache[i]) for i in ref.cache)
    assert got._rng.bit_generator.state == ref._rng.bit_generator.state


def _both(ref, got, fn):
    """fn on both engines: equal answers, or QueryError from both."""
    try:
        want = fn(ref)
    except JaxQueryError:
        with pytest.raises(QueryError):
            fn(got)
        return None
    have = fn(got)
    assert have.dtype == want.dtype and np.array_equal(have, want)
    return have


@pytest.fixture
def fixed_reprep_seed(monkeypatch):
    """An automatic re-prep draws a fresh key from secrets.randbits in
    both packages: pin it, so that both draw the same."""
    monkeypatch.setattr(secrets, "randbits", lambda k: 12345)


def test_prep_state_identical():
    _, ref, got = _pair(4096, 32, 40, 7, 8)
    assert_same_client(ref.client, got.client)
    assert got.server.db.shape == tuple(np.asarray(ref.server.db).shape)
    assert np.array_equal(got.server.db.numpy().view(np.uint32),
                          np.asarray(ref.server.db))
    assert got.local_storage_size() == ref.local_storage_size()
    assert got.comm_cost_per_query() == ref.comm_cost_per_query()
    assert got.client.offset_table_bytes() == ref.client.offset_table_bytes()


def test_full_budget_exact_identical():
    """The exhaustive-budget test (pir_test.go:9-58): the whole
    MaxQueryNum budget of random queries, each answer equal to its raw
    row and to the JAX engine's, the state equal after every query."""
    raw, ref, got = _pair(4096, 32, 40, 7, 8)
    rng = np.random.default_rng(70)
    fails = 0
    for _ in range(ref.params.max_query_num):
        idx = int(rng.integers(0, 4096))
        out = _both(ref, got, lambda e: e.query(idx))
        if out is None:
            fails += 1
        else:
            assert np.array_equal(out, raw[idx]), idx
        assert_same_client(ref.client, got.client)
    assert fails == 0


def test_repeated_idx_uses_cache_identical():
    raw, ref, got = _pair(1024, 32, 20, 9, 10)
    a = _both(ref, got, lambda e: e.query(123))
    consumed = got.client.state.finished
    b = _both(ref, got, lambda e: e.query(123))
    assert np.array_equal(a, b) and np.array_equal(a, raw[123])
    assert got.client.state.finished == consumed      # pir.go:381-383
    assert_same_client(ref.client, got.client)


def test_auto_reprep_after_exhaustion_identical(fixed_reprep_seed):
    """1.5x the budget: the wrapper re-preps transparently (pir.go:525-
    533), and both engines go on in step through the re-prep."""
    raw, ref, got = _pair(1024, 32, 20, 11, 12)
    rng = np.random.default_rng(13)
    seen = 0
    for _ in range(ref.params.max_query_num * 3 // 2):
        idx = int(rng.integers(0, 1024))
        out = _both(ref, got, lambda e: e.query(idx))
        if out is not None:
            assert np.array_equal(out, raw[idx])
            seen += 1
        assert_same_client(ref.client, got.client)
    assert seen > ref.params.max_query_num


def test_out_of_range_raises():
    _, ref, got = _pair(1000, 32, 20, 13, 14)     # C * S = 1,024
    with pytest.raises(QueryError):
        got.client.query(999999, got.server)
    with pytest.raises(QueryError):
        got.server.non_private_query(999999)
    # a padding index below C * S reads zeros, as in the reference
    pad = got.params.db_size
    assert np.array_equal(got.server.non_private_query(pad),
                          ref.server.non_private_query(pad))
    assert_same_client(ref.client, got.client)


def test_dummy_query_touches_server_only():
    _, ref, got = _pair(256, 32, 20, 15, 16)
    before = got.client.state.finished
    out = _both(ref, got, lambda e: e.query(0, real=False))
    assert np.all(out == 0) and got.client.state.finished == before
    assert_same_client(ref.client, got.client)


def test_server_batch_matches_jax():
    """The server's answers to a batch of offset vectors with a skip mask:
    the port's K7c plain version against the JAX host scan."""
    _, ref, got = _pair(4096, 96, 20, 17, 18)
    p = got.params
    rng = np.random.default_rng(19)
    off = rng.integers(0, p.chunk_size, size=(37, p.set_size),
                       dtype=np.uint32)
    skip = rng.random((37, p.set_size)) < 0.3
    want = ref.server.private_query_batch(off, skip)
    assert np.array_equal(got.server.private_query_batch(off, skip), want)
    assert np.array_equal(got.server.private_query_batch(off),
                          ref.server.private_query_batch(off))


def test_use_device_prep_false_identical():
    """use_device_prep=False asks for the PRF table on the CPU: the same
    state (the device here is the CPU as well)."""
    _, ref, got = _pair(1024, 32, 20, 21, 22, use_device_prep=False)
    assert got.client._prep_device().type == "cpu"
    assert_same_client(ref.client, got.client)


def test_dummy_preprocessing_identical():
    raw = _rand_db(np.random.default_rng(23), 512, 8)
    ref = JaxPIR(512, 32, raw, failure_prob_log2=20)
    got = PianoPIR(512, 32, raw, failure_prob_log2=20, device="cpu")
    ref.dummy_preprocessing(rng=np.random.default_rng(24))
    got.dummy_preprocessing(rng=np.random.default_rng(24))
    assert_same_client(ref.client, got.client)


def test_prep_launches_k1_and_k7c_only(monkeypatch):
    """The passes go through the dispatchers of kernels K1 and K7c: with
    their CUDA wrappers standing in for the plain versions, prep calls K1
    once and K7c once (staged form where flat_form picks it), and every
    query, real or dummy, K7c once in its row form. The host tier, which
    takes the CPU's passes where native_lib is available, is turned off."""
    monkeypatch.setattr(native_lib, "available", lambda: False)
    calls = []
    k1_plain, k7c_plain = aes.prf_tables_plain, attic.xor_scan_pallas_plain

    def k1(rk, T, S, mask):
        calls.append(("K1", rk.shape[0]))
        return k1_plain(rk, T, S, mask)

    def k7c(db, off, skip, k):
        B, S = off.shape
        calls.append(("K7c", attic.flat_form(B, S, db.shape[1] // k, k)))
        return k7c_plain(db, off, skip, k)

    monkeypatch.setattr(aes, "prf_tables_plain", k1)
    monkeypatch.setattr(attic, "xor_scan_pallas_plain", k7c)
    raw = _rand_db(np.random.default_rng(25), 16384, 8)
    got = PianoPIR(16384, 32, raw, failure_prob_log2=8, device="cpu")
    got.preprocessing(rng=np.random.default_rng(26))
    p = got.params
    T = p.primary_hint_num + p.set_size * p.max_query_per_chunk
    want = attic.flat_form(T, p.set_size, p.chunk_size, 1)
    assert calls == [("K1", 1), ("K7c", want)]
    calls.clear()
    got.query(5, real=False)
    try:
        assert np.array_equal(got.query(77), raw[77])
    except QueryError:
        pass
    assert calls[0] == ("K7c", "row") and set(calls) == {("K7c", "row")}


def test_entry_points_default_to_cuda(monkeypatch):
    """device=None means the card: without CUDA the engine raises and
    never lands on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    raw = _rand_db(np.random.default_rng(27), 256, 8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PianoPIR(256, 32, raw, failure_prob_log2=20)
    got = PianoPIR(256, 32, raw, failure_prob_log2=20, device="cpu")
    assert got.server.db.device.type == "cpu"
    assert got.client.device.type == "cpu"
