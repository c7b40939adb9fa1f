"""The big tier: above 4 GiB of packed DB (_PREP_SPLIT_DB_BYTES) the JAX
engine runs prep as two programs (_prep_tables_big, then _prep_scan_big)
and each online round as three (select, server scan, finish), and its
fused search chains programs a step (split_route); the port keeps one form
at every size. Each test holds that form against the JAX split forms at a
small size: the threshold is monkeypatched low, so the split forms run
without editing a file."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pacmann_tpu.ops import aes as jaes
from pacmann_tpu.pir import device_engine as jde
from pacmann_tpu.private.fused_search import FusedPrivateSearch as JaxSearch
from pacmann_tpu.private.fused_search import _draw_step_randoms
from pacmann_tpu.private.oracle import pack_vertex_db
from pacmann_tpu_torch.ops import aes
from pacmann_tpu_torch.pir.convert import rk_from_masks, state_to_numpy
from pacmann_tpu_torch.pir.device_engine import (
    DevicePianoEngine, prep_partitions)
from pacmann_tpu_torch.private.fused_search import FusedPrivateSearch
from pacmann_tpu_torch.utils.u32 import from_u32, to_u32

torch.set_num_threads(1)


def _assert_state(ref, got):
    want = {k: np.asarray(v) for k, v in jax.device_get(ref.state).items()}
    have = state_to_numpy(got.state)
    if "masks" in want:
        assert np.array_equal(have.pop("rk"), rk_from_masks(
            want.pop("masks")))
    assert set(have) == set(want)
    for key, v in want.items():
        assert np.array_equal(have[key], v.astype(np.uint32)), key
    assert got.queries_made_in_partition == ref.queries_made_in_partition


def test_prep_matches_two_program_prep():
    """The port's one-form offline pass (prep_partitions) against JAX's
    big-tier pair, called as tests/test_device_engine.py calls them: the
    same tables, slot columns, parities and replacement values."""
    rng = np.random.default_rng(77)
    n, entry_bytes, batch = 4096, 16, 8
    raw = rng.integers(0, 2**32, size=(n, entry_bytes // 4), dtype=np.uint32)
    eng = jde.DevicePianoEngine(n, entry_bytes, batch, raw, 8)
    p, P = eng.params, eng.config.partition_num
    S, R, Hp, C = (p.set_size, p.max_query_per_chunk,
                   p.primary_hint_num, p.chunk_size)
    T = Hp + S * R
    keys16 = [rng.bytes(16) for _ in range(P)]
    masks = jnp.asarray(np.stack([jaes.expand_key_planes(k) for k in keys16]))
    repl_off = rng.integers(0, C, size=(P, S, R), dtype=np.uint32)
    table, slot_col = jde._prep_tables_big(
        masks, T=T, S=S, C=C, Hp=Hp, chunk_mask=p.chunk_mask)
    par, repl, _ = jde._prep_scan_big(
        eng.db, table, slot_col, jnp.asarray(repl_off), T=T, S=S, Hp=Hp,
        R=R, k=eng.k)
    got = DevicePianoEngine(n, entry_bytes, batch, raw, 8, device="cpu")
    g_table, g_par, g_repl, g_slot = prep_partitions(
        got.db, aes.round_keys(keys16), from_u32(repl_off), Hp=Hp, R=R,
        chunk_mask=p.chunk_mask, k=got.k)
    for name, have, want in (("table", g_table, table),
                             ("slot_col", g_slot, slot_col),
                             ("parities", g_par, par),
                             ("repl_val", g_repl, repl)):
        assert np.array_equal(to_u32(have), np.asarray(want).astype(
            np.uint32)), name


@pytest.mark.parametrize("table_free", [False, True])
def test_engine_matches_split_online_round(monkeypatch, table_free):
    """With the threshold at 0 every JAX batch round runs as the split
    select / server scan / finish programs; the port's one-form round gives
    the same answers and state over three batches, table-free too."""
    monkeypatch.setattr(jde, "_PREP_SPLIT_DB_BYTES", 0)
    rng = np.random.default_rng(78)
    n, eb, batch = 8192, 32, 32
    raw = rng.integers(0, 2**32, size=(n, eb // 4), dtype=np.uint32)
    ref = jde.DevicePianoEngine(n, eb, batch, raw, 20, table_free=table_free)
    got = DevicePianoEngine(n, eb, batch, raw, 20, device="cpu",
                            table_free=table_free)
    ref.preprocessing(rng=np.random.default_rng(7))
    got.preprocessing(rng=np.random.default_rng(7))
    _assert_state(ref, got)
    qrng = np.random.default_rng(8)
    for i in range(3):
        ids = [int(x) for x in qrng.integers(0, n, 2 * batch)]
        ref._rng = np.random.default_rng(20 + i)
        got._rng = np.random.default_rng(20 + i)
        assert np.array_equal(got.query(ids), ref.query(ids))
        _assert_state(ref, got)


def test_fused_search_matches_split_route():
    """JAX's fused search forced onto its chained-programs route
    (split_route=True) against the port's one form, JAX's draws fed in:
    the same answers, reach steps, fetch counters and state."""
    rng = np.random.default_rng(41)
    n, d, m = 1024, 8, 8
    vectors = rng.integers(0, 8, size=(n, d)).astype(np.float32)
    graph = rng.integers(0, n, size=(n, m))
    raw = pack_vertex_db(vectors, graph)
    sids = rng.choice(n, 32, replace=False)
    ref_e = jde.DevicePianoEngine(n, 4 * (d + m), m, raw, 8)
    got_e = DevicePianoEngine(n, 4 * (d + m), m, raw, 8, device="cpu")
    for e in (ref_e, got_e):
        e.preprocessing(rng=np.random.default_rng(99))
    ref = JaxSearch(ref_e, sids, vectors[sids], graph[sids], dim=d, m=m, n=n)
    ref.split_route = True
    got = FusedPrivateSearch(got_e, sids, vectors[sids], graph[sids], dim=d,
                             m=m, n=n)
    Qn, parallel, max_step, seed = 2, 2, 5, 7
    q = rng.integers(0, 8, size=(Qn, d)).astype(np.float32)
    ids_r, st_r = ref.search(q, k=5, max_step=max_step, parallel=parallel,
                             seed=seed, return_steps=True)
    keys = jax.random.split(jax.random.PRNGKey(seed), max_step)
    randoms = _draw_step_randoms(
        keys, Qn=Qn, parallel=parallel, m=m, n=n,
        quota=Qn * parallel * m // got_e.config.partition_num,
        P=got_e.config.partition_num, S=got_e.params.set_size,
        C=got_e.params.chunk_size)
    ids_g, st_g = got.search(q, k=5, max_step=max_step, parallel=parallel,
                             step_randoms=tuple(np.asarray(a)
                                                for a in randoms),
                             return_steps=True)
    assert np.array_equal(ids_g, ids_r) and np.array_equal(st_g, st_r)
    assert (ids_g >= 0).any()
    assert np.array_equal(got.fetch_stats, ref.fetch_stats)
    _assert_state(ref_e, got_e)
