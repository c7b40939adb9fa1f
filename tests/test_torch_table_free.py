"""The port's table-free client and measure_comm mode against the JAX
package, on the CPU (plain versions of kernels K1, K2, K4 and K5).

Everything is bit-exact: the per-point PRF (kernel K5's contract) against
the JAX package's prf_eval_fused, the host AES oracle and the port's own
offset tables; the table-free engine's answers and every state array after
preprocessing and after each batch, on each protocol route; the fused
search's ids, steps and counters; the measured message bytes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pacmann_tpu.ops import aes as jax_aes
from pacmann_tpu.pir.device_engine import DevicePianoEngine as JaxEngine
from pacmann_tpu.private.fused_search import FusedPrivateSearch as JaxSearch
from pacmann_tpu.private.fused_search import _draw_step_randoms
from pacmann_tpu.private.oracle import pack_vertex_db
from pacmann_tpu_torch.ops import aes, aes_host
from pacmann_tpu_torch.pir import device_engine as tde
from pacmann_tpu_torch.pir.convert import (
    db_from_numpy, rk_from_masks, state_from_numpy, state_to_numpy)
from pacmann_tpu_torch.pir.device_engine import (
    STATE_KEYS, TABLE_FREE_STATE_KEYS)
from pacmann_tpu_torch.pir.device_engine import DevicePianoEngine as TorchEngine
from pacmann_tpu_torch.private.fused_search import (
    FusedPrivateSearch as TorchSearch)
from pacmann_tpu_torch.utils import cuda_lib

# Tests run in several worker processes at once; torch's default of one
# intra-op thread per core oversubscribes the machine, and these tensors
# are small.
torch.set_num_threads(1)


def _raw(n, entry_bytes, seed):
    return np.random.default_rng(seed).integers(
        0, 2**32, size=(n, entry_bytes // 4), dtype=np.uint32)


def _assert_same_state(ref, got):
    """The port's state equals the JAX engine's: every array bit for bit,
    the round keys against the JAX engine's key masks, and the budget
    accounting."""
    want = {k: np.asarray(v) for k, v in jax.device_get(ref.state).items()}
    have = state_to_numpy(got.state)
    assert set(have) == set(TABLE_FREE_STATE_KEYS)
    assert np.array_equal(have["rk"], rk_from_masks(want.pop("masks")))
    for key in TABLE_FREE_STATE_KEYS[1:]:
        assert have[key].shape == want[key].shape, key
        assert np.array_equal(have[key], want[key].astype(np.uint32)), key
    assert got.queries_made_in_partition == ref.queries_made_in_partition
    assert got.finished_batch_num == ref.finished_batch_num


def test_prf_eval_plain_matches_jax_host_and_tables():
    """P = 4, L = 75 points a partition (not a multiple of 32), tags over
    the whole tag range [0, T): the plain version equals the JAX package's
    prf_eval_fused, the host AES oracle, and the port's offset tables at
    the same (t, s)."""
    rng = np.random.default_rng(41)
    P, L, T, S, cm = 4, 75, 300, 20, 0x3FF
    keys = [rng.bytes(16) for _ in range(P)]
    tags = rng.integers(0, T, size=(P, L)).astype(np.uint32)
    tags[:, 0] = T - 1
    xs = rng.integers(0, S, size=(P, L)).astype(np.uint32)
    rk = aes.round_keys(keys)
    got = aes.prf_eval_plain(rk, torch.from_numpy(tags.view(np.int32)),
                             torch.from_numpy(xs.view(np.int32)), cm)
    got = got.numpy().view(np.uint32)
    assert got.shape == (P, L)

    masks = jnp.asarray(np.stack([jax_aes.expand_key_planes(k)
                                  for k in keys]))
    want = np.asarray(jax_aes.prf_eval_fused(masks, jnp.asarray(tags),
                                             jnp.asarray(xs), cm))
    assert np.array_equal(got, want)
    host = np.stack([
        (aes_host.prf_eval_u64(aes_host.expand_key(k),
                               tags[p].astype(np.uint64),
                               xs[p].astype(np.uint64))
         & np.uint64(cm)).astype(np.uint32) for p, k in enumerate(keys)])
    assert np.array_equal(got, host)
    table = aes.prf_tables_plain(rk, T, S, cm).numpy().view(np.uint32)
    p_ix = np.arange(P)[:, None]
    assert np.array_equal(got, table[p_ix, tags, xs])


def test_prf_eval_plain_full_u32_inputs(monkeypatch):
    """Tags and xs over the whole u32 range (the TPU kernel's u32 shift
    drops tag bits above 28) and an all-ones mask, across plain-version
    block seams: equal to prf_eval_fused."""
    rng = np.random.default_rng(42)
    P, L = 2, 37
    keys = [rng.bytes(16) for _ in range(P)]
    tags = rng.integers(0, 2**32, size=(P, L), dtype=np.uint64)
    xs = rng.integers(0, 2**32, size=(P, L), dtype=np.uint64)
    tags, xs = tags.astype(np.uint32), xs.astype(np.uint32)
    masks = jnp.asarray(np.stack([jax_aes.expand_key_planes(k)
                                  for k in keys]))
    want = np.asarray(jax_aes.prf_eval_fused(
        masks, jnp.asarray(tags), jnp.asarray(xs), np.uint32(0xFFFFFFFF)))
    monkeypatch.setattr(aes, "_PLAIN_BLOCK", 16)
    got = aes.prf_eval_plain(aes.round_keys(keys),
                             torch.from_numpy(tags.view(np.int32)),
                             torch.from_numpy(xs.view(np.int32)), 0xFFFFFFFF)
    assert np.array_equal(got.numpy().view(np.uint32), want)


@pytest.mark.parametrize("L", [1, 511, 513, 1488])
def test_prf_eval_plain_matches_jax_pallas_at_ragged_lengths(L, monkeypatch):
    """K5's contract at ragged list lengths (P = 3; 1,488 is a partition's
    list at Q = 6): the plain version equals the JAX package's
    prf_eval_fused_pallas, run as that package's CPU tests run it (its
    kernel body swapped for the XLA twin of the circuit; the interpreted
    kernel takes minutes to compile), and the host AES oracle; half the
    tags at or above 2^29, whose bits above 28 drop out."""
    import jax.numpy as jnp2

    from pacmann_tpu.ops import aes_pallas

    def twin_blocks(m16, s0, *, ws, interpret):
        P, _, _, Ls, _ = s0.shape
        outs = []
        for p in range(P):
            blocks = []
            for ib in range(Ls // ws):
                planes = [s0[p, b, :, ib * ws:(ib + 1) * ws]
                          for b in range(8)]
                o = aes_pallas._mmo_low32_planes(
                    planes, lambda r, b: m16[p, r, b],
                    aes_pallas._perm_take)
                blocks.append(jnp2.stack(o))
            outs.append(jnp2.concatenate(blocks, axis=2))
        return jnp2.stack(outs)

    monkeypatch.setattr(aes_pallas, "_aes_mmo_low32_blocks_perp",
                        twin_blocks)
    rng = np.random.default_rng(43 + L)
    P, cm = 3, 0x1FF
    keys = [rng.bytes(16) for _ in range(P)]
    tags = rng.integers(0, 12_512, size=(P, L)).astype(np.uint32)
    high = rng.random((P, L)) < 0.5
    tags[high] = rng.integers(1 << 29, 1 << 32, size=(P, L),
                              dtype=np.uint64)[high].astype(np.uint32)
    xs = rng.integers(0, 124, size=(P, L)).astype(np.uint32)
    got = aes.prf_eval_plain(aes.round_keys(keys),
                             torch.from_numpy(tags.view(np.int32)),
                             torch.from_numpy(xs.view(np.int32)), cm)
    got = got.numpy().view(np.uint32)
    masks = jnp.asarray(np.stack([jax_aes.expand_key_planes(k)
                                  for k in keys]))
    with jax.disable_jit():       # op by op: no compile of the circuit
        want = np.asarray(aes_pallas.prf_eval_fused_pallas(
            masks, jnp.asarray(tags), jnp.asarray(xs), cm))
    assert np.array_equal(got, want)
    host = np.stack([
        (aes_host.prf_eval_u64(aes_host.expand_key(k),
                               tags[p].astype(np.uint64),
                               xs[p].astype(np.uint64))
         & np.uint64(cm)).astype(np.uint32) for p, k in enumerate(keys)])
    assert np.array_equal(got, host)


def test_prf_eval_routes_cpu_to_plain(monkeypatch):
    """A CPU tensor never reaches cuda_lib from prf_eval; the kernel
    wrapper refuses it and counts no launch."""
    def no_cuda(*a, **k):
        raise AssertionError("cuda_lib reached with CPU tensors")

    monkeypatch.setattr(cuda_lib, "load", no_cuda)
    monkeypatch.setattr(cuda_lib, "function", no_cuda)
    rk = aes.round_keys([bytes(16), bytes(range(16))])
    tags = torch.arange(10, dtype=torch.int32).repeat(2, 1)
    xs = torch.arange(10, dtype=torch.int32).flip(0).repeat(2, 1)
    launches = aes.aes_mmo_points_cuda.launches
    assert torch.equal(aes.prf_eval(rk, tags, xs, 15),
                       aes.prf_eval_plain(rk, tags, xs, 15))
    with pytest.raises(ValueError):
        aes.aes_mmo_points_cuda(rk, tags, xs, 15)     # not a CUDA tensor
    assert aes.aes_mmo_points_cuda.launches == launches


def test_numpy_raw_defaults_to_cuda(monkeypatch):
    """A numpy raw with no device goes to CUDA: without CUDA the engine
    raises and never lands on the CPU. A tensor raw and a packed DB keep
    their own device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    raw = _raw(2048, 32, 0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TorchEngine(2048, 32, 32, raw, 20)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TorchEngine(2048, 32, 32, raw, 20, device="cuda")
    e = TorchEngine(2048, 32, 32, torch.from_numpy(raw.view(np.int32)), 20)
    assert e.device.type == "cpu" and e.db.device.type == "cpu"
    e2 = TorchEngine(2048, 32, 32, None, 20, packed_db=e.db)
    assert e2.device.type == "cpu"
    assert TorchEngine(2048, 32, 32, raw, 20, device="cpu").device.type \
        == "cpu"


def _tf_pair(route, n=4096, seed=0, prep_seed=7):
    raw = _raw(n, 32, seed)
    ref = JaxEngine(n, 32, 32, raw, 20, table_free=True, kernel_route=route)
    got = TorchEngine(n, 32, 32, raw, 20, device="cpu", table_free=True,
                      kernel_route=route)
    ref.preprocessing(rng=np.random.default_rng(prep_seed))
    got.preprocessing(rng=np.random.default_rng(prep_seed))
    return raw, ref, got


@pytest.mark.parametrize("route", ["xla", "pallas", "fused"])
def test_table_free_engine_matches_jax(route):
    """The table-free engine against the JAX one on each protocol route:
    the state after preprocessing and after each of 3 batches (spread,
    duplicate, random), and the answers, which are the raw rows."""
    raw, ref, got = _tf_pair(route, seed=1, prep_seed=11)
    assert "table" not in got.state
    _assert_same_state(ref, got)
    c = ref.config
    rng = np.random.default_rng(2)
    spread = [int(i * c.partition_size + rng.integers(0, c.partition_size))
              for i in range(c.partition_num)] * 2
    batches = (spread, [7] * 32,
               [int(i) for i in rng.integers(0, raw.shape[0], 32)])
    for ids in batches:
        out_ref = ref.query(ids)
        out_got = got.query(ids)
        assert np.array_equal(out_got, out_ref)
        _assert_same_state(ref, got)
    for idx in spread:
        assert np.array_equal(got.cache[idx], raw[idx])


def test_table_free_dummy_preprocessing_matches_jax():
    """dummy_preprocessing draws the P keys after the zero state: the same
    keys as the JAX engine, the same state, and the same answers to a
    batch (zero rows: the hints are zeroed)."""
    _, ref, got = _tf_pair("xla", n=2048, seed=10)
    ref.dummy_preprocessing(rng=np.random.default_rng(3))
    got.dummy_preprocessing(rng=np.random.default_rng(3))
    _assert_same_state(ref, got)
    ids = [int(i) for i in np.random.default_rng(4).integers(0, 2048, 32)]
    assert np.array_equal(got.query(ids), ref.query(ids))
    _assert_same_state(ref, got)


@pytest.mark.parametrize("refresh", ["scatter", "dense"])
def test_table_free_matches_table_engine(refresh):
    """Inside the port: a table-free engine and a table engine on the same
    seeds hold the same state (all but table / rk) through a contended raw
    round in each refresh form and then a query batch; the round keys are
    the table's keys."""
    n = 2048
    raw = _raw(n, 32, 8)
    a = TorchEngine(n, 32, 32, raw, 20, device="cpu")
    b = TorchEngine(n, 32, 32, raw, 20, device="cpu", table_free=True)
    a.preprocessing(rng=np.random.default_rng(102))
    b.preprocessing(rng=np.random.default_rng(102))
    p = a.params
    T = p.primary_hint_num + p.set_size * p.max_query_per_chunk
    assert torch.equal(aes.prf_tables(b.state["rk"], T, p.set_size,
                                      p.chunk_mask), a.state["table"])
    Q, P = 16, a.config.partition_num
    idx_q = np.full((Q, P), 17, np.int32)
    rand_offs = (np.random.default_rng(9).integers(
        0, 2**32, size=(Q, P, p.set_size), dtype=np.uint64)
        & np.uint64(p.chunk_mask)).astype(np.uint32)
    e_a, ok_a = a._online(idx_q, rand_offs, refresh=refresh)
    e_b, ok_b = b._online(idx_q, rand_offs, refresh=refresh)
    assert torch.equal(ok_a, ok_b) and torch.equal(e_a, e_b)
    assert 5 <= int(ok_b.sum(dim=0).min()) < Q      # contention is real
    a._rng = np.random.default_rng(5)
    b._rng = np.random.default_rng(5)
    ids = [int(i) for i in np.random.default_rng(6).integers(0, n, 32)]
    assert np.array_equal(a.query(ids), b.query(ids))
    assert set(b.state) == set(TABLE_FREE_STATE_KEYS)
    for key in STATE_KEYS[1:]:
        assert torch.equal(a.state[key], b.state[key]), key


def test_extra_storage_size_matches_jax():
    raw = _raw(4096, 32, 3)
    sizes = {}
    for tf in (False, True):
        ref = JaxEngine(4096, 32, 32, raw, 20, table_free=tf)
        got = TorchEngine(4096, 32, 32, raw, 20, device="cpu", table_free=tf)
        sizes[tf] = got.extra_storage_size()
        assert sizes[tf] == ref.extra_storage_size(), tf
    assert 0 < sizes[True] < sizes[False]


@pytest.mark.parametrize("table_free,route", [(False, "xla"),
                                              (True, "pallas")])
def test_measure_comm_matches_model_and_jax(table_free, route):
    """measure_comm (twin of the JAX engine's test): the offset upload and
    entry download byte counts equal the reference's analytic model
    (pir.go:539-544, batch-pir.go:258-264) and the JAX engine's counts,
    the answers are the raw rows, and the state equals the JAX engine's
    and the unmeasured engine's."""
    rng = np.random.default_rng(62)
    n, entry_bytes, batch = 8192, 32, 32
    raw = rng.integers(0, 2**32, size=(n, entry_bytes // 4), dtype=np.uint32)
    kw = dict(table_free=table_free, kernel_route=route)
    ref = JaxEngine(n, entry_bytes, batch, raw, 20, measure_comm=True, **kw)
    got = TorchEngine(n, entry_bytes, batch, raw, 20, device="cpu",
                      measure_comm=True, **kw)
    plain = TorchEngine(n, entry_bytes, batch, raw, 20, device="cpu", **kw)
    for e in (ref, got, plain):
        e.preprocessing(rng=np.random.default_rng(104))
    c, p = got.config, got.params
    batches = 3
    for b in range(batches):
        ids = [int(i * c.partition_size + rng.integers(0, c.partition_size))
               for i in range(c.partition_num)] * 2
        # retries=0: the analytic model counts one round per batch
        outs = [e.query(ids, retries=0) for e in (ref, got, plain)]
        for r, idx in enumerate(ids):
            assert np.array_equal(outs[1][r], raw[idx]), (b, r)
        assert np.array_equal(outs[1], outs[0])
        assert np.array_equal(outs[1], outs[2])
    up_model = 2 * c.partition_num * p.set_size * 4 * batches
    down_model = 2 * c.partition_num * entry_bytes * batches
    assert got.uploaded_bytes == up_model == ref.uploaded_bytes
    assert got.downloaded_bytes == down_model == ref.downloaded_bytes
    assert got.comm_cost_per_batch_online() == (
        up_model + down_model) // batches
    assert plain.uploaded_bytes == plain.downloaded_bytes == 0
    for key, v in state_to_numpy(plain.state).items():
        assert np.array_equal(state_to_numpy(got.state)[key], v), key
    if table_free:
        _assert_same_state(ref, got)


def test_fused_search_on_table_free_engine_matches_jax():
    """The fused search over a table-free engine (twin of the JAX package's
    fused table-free test): ids, reach steps, fetch counters, budget
    accounting and the PIR state equal the JAX search's, given the JAX
    per-step draws."""
    rng = np.random.default_rng(21)
    n, d, m = 1024, 8, 8
    vectors = rng.integers(0, 8, size=(n, d)).astype(np.float32)
    graph = rng.integers(0, n, size=(n, m))
    raw = pack_vertex_db(vectors, graph)
    sids = rng.choice(n, 32, replace=False)
    ref, got = (
        Search(Engine(n, 4 * (d + m), m, raw, 8, table_free=True, **kw),
               sids, vectors[sids], graph[sids], dim=d, m=m, n=n)
        for Engine, Search, kw in ((JaxEngine, JaxSearch, {}),
                                   (TorchEngine, TorchSearch,
                                    {"device": "cpu"})))
    for fs in (ref, got):
        fs.engine.preprocessing(rng=np.random.default_rng(5))
    Qn, parallel, max_step, seed = 2, 2, 6, 6
    queries = rng.integers(0, 8, size=(Qn, d)).astype(np.float32)
    P = got.engine.config.partition_num
    keys = jax.random.split(jax.random.PRNGKey(seed), max_step)
    randoms = [np.asarray(a) for a in _draw_step_randoms(
        keys, Qn=Qn, parallel=parallel, m=m, n=n,
        quota=Qn * parallel * m // P, P=P, S=got.engine.params.set_size,
        C=got.engine.params.chunk_size)]
    ids_r, st_r = ref.search(queries, k=5, max_step=max_step,
                             parallel=parallel, seed=seed, return_steps=True)
    ids_g, st_g = got.search(queries, k=5, max_step=max_step,
                             parallel=parallel, step_randoms=randoms,
                             return_steps=True)
    assert np.array_equal(ids_g, ids_r) and (ids_g >= 0).any()
    assert np.array_equal(st_g, st_r)
    assert np.array_equal(got.fetch_stats, ref.fetch_stats)
    assert got.refreshes == ref.refreshes
    _assert_same_state(ref.engine, got.engine)


def test_state_from_numpy_converts_table_free_state():
    """A JAX table-free state (key masks, no table) carried into the port
    answers the next batch exactly as the JAX engine does."""
    raw, ref, _ = _tf_pair("xla", seed=5, prep_seed=13)
    got = TorchEngine(4096, 32, 32, None, 20, table_free=True,
                      packed_db=db_from_numpy(np.asarray(ref.db), "cpu"))
    got.state = state_from_numpy(jax.device_get(ref.state), "cpu")
    assert set(got.state) == set(TABLE_FREE_STATE_KEYS)
    assert got.state["rk"].dtype == torch.uint8
    _assert_same_state(ref, got)
    ref._rng = np.random.default_rng(21)
    got._rng = np.random.default_rng(21)
    ids = [int(i) for i in np.random.default_rng(6).integers(0, 4096, 32)]
    assert np.array_equal(got.query(ids), ref.query(ids))
    _assert_same_state(ref, got)


def test_table_free_select_carries_refresh_columns():
    """_pir_select with round keys returns the refreshed slots' columns in
    sel, equal to the table rows of the consumed backup tags, and the same
    query sets as the table select; with a table it carries none."""
    n = 2048
    raw = _raw(n, 32, 14)
    a = TorchEngine(n, 32, 32, raw, 20, device="cpu")
    a.preprocessing(rng=np.random.default_rng(15))
    st = a.state
    p = a.params
    P = a.config.partition_num
    # the keys of that preprocessing: the draw order is repl_off, then keys
    g = np.random.default_rng(15)
    g.integers(0, 2**32, size=(P, p.set_size, p.max_query_per_chunk),
               dtype=np.uint64)
    rk = aes.round_keys([g.bytes(16) for _ in range(P)])
    carry = (st["tag"], st["prog"], st["primary_parity"], st["slot_col"],
             st["hist"], st["finished"])
    rng = np.random.default_rng(16)
    idx_q = torch.from_numpy(rng.integers(
        -1, a.config.partition_size, size=(6, P)).astype(np.int32))
    rnd = torch.from_numpy(rng.integers(0, p.chunk_size,
                                        size=(6, P, p.set_size))
                           .astype(np.int32))
    kw = dict(C=p.chunk_size, R=p.max_query_per_chunk, Hp=p.primary_hint_num,
              S=p.set_size, max_q=p.max_query_num, dpp=0x7FFFFFFF)
    sel_t, qs_t = tde._pir_select(st["table"], st["repl_idx"], carry, idx_q,
                                  rnd, route="xla", **kw)
    sel_f, qs_f = tde._pir_select(None, st["repl_idx"], carry, idx_q, rnd,
                                  route="xla", rk=rk, **kw)
    assert sel_t[6] is None
    assert torch.equal(qs_t, qs_f)
    for x, y in zip(sel_t[:6], sel_f[:6]):
        assert torch.equal(x, y)
    hit, ok_q, ok_r, ig, chunk = sel_f[:5]
    btag = p.primary_hint_num + chunk * p.max_query_per_chunk + ig
    want = st["table"][torch.arange(P)[None, :], btag]
    assert torch.equal(sel_f[6], want)
