"""The port's sharded engines (pacmann_tpu_torch/pir/sharded_engine.py)
against the JAX package's, twin for twin of tests/test_sharded_engine.py:
meshes of CPU shards (["cpu"] * n) beside conftest's eight virtual JAX
devices, the same raw DB and numpy seeds, and bit-exact answers, state
(after prep and after every batch) and budget accounting, on every route
and table-free. The port's single-device engine is held beside them."""

import jax
import numpy as np
import pytest
import torch

from pacmann_tpu.parallel.sharding import make_mesh as jmake_mesh
from pacmann_tpu.pir.sharded_engine import (
    ChunkShardedPianoEngine as JaxChunkSharded)
from pacmann_tpu.pir.sharded_engine import ShardedPianoEngine as JaxSharded
from pacmann_tpu.private.fused_search import FusedPrivateSearch as JaxSearch
from pacmann_tpu.private.fused_search import _draw_step_randoms
from pacmann_tpu.private.oracle import pack_vertex_db
from pacmann_tpu_torch.parallel.sharding import make_mesh
from pacmann_tpu_torch.pir import device_engine as tde
from pacmann_tpu_torch.pir.convert import (
    load_state, rk_from_masks, state_to_numpy)
from pacmann_tpu_torch.pir.device_engine import DevicePianoEngine
from pacmann_tpu_torch.pir.sharded_engine import (
    ChunkShardedPianoEngine, ShardedPianoEngine)
from pacmann_tpu_torch.private.fused_search import FusedPrivateSearch

torch.set_num_threads(1)

LARGE = ("table", "primary_parity", "backup_parity", "slot_col",
         "repl_idx", "repl_val")


def _cpu_mesh(n):
    return make_mesh(devices=["cpu"] * n)


def _assert_state(jax_engine, got):
    """The port's state (gathered) equals the JAX engine's (global numpy
    arrays), a table-free engine's round keys against its key masks."""
    want = {k: np.asarray(v) for k, v in jax.device_get(
        jax_engine.state).items()}
    have = state_to_numpy(got.state)
    if "masks" in want:
        assert np.array_equal(have.pop("rk"), rk_from_masks(
            want.pop("masks")))
    assert set(have) == set(want)
    for key, v in want.items():
        assert np.array_equal(have[key], v.astype(np.uint32)), key
    assert got.queries_made_in_partition == \
        jax_engine.queries_made_in_partition


def _assert_same(a, b):
    sa, sb = state_to_numpy(a.state), state_to_numpy(b.state)
    assert set(sa) == set(sb)
    for key in sa:
        assert np.array_equal(sa[key], sb[key]), key


def _query_all(engines, ids, seed=9):
    """One batch of `ids` on every engine, each drawing its dummy offsets
    from the same seed: the answers are equal. Returns them."""
    outs = []
    for e in engines:
        e._rng = np.random.default_rng(seed)
        outs.append(e.query(list(ids)))
    for out in outs[1:]:
        assert np.array_equal(out, outs[0])
    return outs[0]


@pytest.mark.parametrize("route", ["xla", "fused"])
def test_sharded_engine_exact_answers(route):
    """16 partitions over 8 shards: every answer is its raw row and equals
    the JAX sharded engine's, state after prep and after the batch too (the
    port's "fused" route, K3's plain version, against JAX's "xla": every
    route gives the same state)."""
    rng = np.random.default_rng(70)
    n, eb, batch = 8192, 32, 32
    raw = rng.integers(0, 2**32, size=(n, 8), dtype=np.uint32)
    ref = JaxSharded(n, eb, batch, raw, 20, jmake_mesh(8))
    got = ShardedPianoEngine(n, eb, batch, raw, 20, _cpu_mesh(8),
                             kernel_route=route)
    ref.preprocessing(rng=np.random.default_rng(100))
    got.preprocessing(rng=np.random.default_rng(100))
    _assert_state(ref, got)
    c = got.config
    ids = []
    for _ in range(2):
        ids += [int(i * c.partition_size + rng.integers(0, c.partition_size))
                for i in range(c.partition_num)]
    out = _query_all((ref, got), ids)
    assert np.array_equal(out, raw[ids])
    _assert_state(ref, got)


def test_shard_native_prep_memory_locality(monkeypatch):
    """No shard ever holds more than its partitions: every pack call spans
    P / n_dev partitions (the whole DB is never packed), each shard's DB and
    large state leaves span P / n_dev partitions, as the JAX engine's
    addressable shards do, and the engine still answers exactly."""
    packs = []
    pack = tde.pack_partitions

    def spy(raw, lo_p, hi_p, **kw):
        packs.append((lo_p, hi_p))
        return pack(raw, lo_p, hi_p, **kw)

    def whole(*a, **kw):
        raise AssertionError("the whole DB was packed")

    monkeypatch.setattr(tde, "pack_partitions", spy)
    monkeypatch.setattr(tde, "pack_db", whole)
    rng = np.random.default_rng(72)
    n, eb, batch = 8192, 32, 32
    raw = rng.integers(0, 2**32, size=(n, 8), dtype=np.uint32)
    pir = ShardedPianoEngine(n, eb, batch, raw, 20, _cpu_mesh(8))
    pir.preprocessing(rng=np.random.default_rng(101))
    P = pir.config.partition_num
    per = P // 8
    assert packs == [(d * per, (d + 1) * per) for d in range(8)]
    ref = JaxSharded(n, eb, batch, raw, 20, jmake_mesh(8))
    assert [s.data.shape[1] for s in ref.db.addressable_shards] == [per] * 8
    assert [db.shape[1] for db in pir.db] == [per] * 8
    for st in pir.shard_states:
        for name in LARGE:
            assert st[name].shape[0] == per, name
    ids = [int(i * pir.config.partition_size + 1) for i in range(P)]
    out = pir.query(ids)
    assert np.array_equal(out, raw[ids])


def test_sharded_table_free_matches_single_chip():
    """Table-free (round keys "rk" in place of the table) per shard:
    answers and state equal the JAX sharded table-free engine's (its key
    masks) and the port's single table-free engine's."""
    rng = np.random.default_rng(73)
    n, eb, batch = 4096, 32, 32
    raw = rng.integers(0, 2**32, size=(n, 8), dtype=np.uint32)
    ref = JaxSharded(n, eb, batch, raw, 20, jmake_mesh(8), table_free=True)
    single = DevicePianoEngine(n, eb, batch, raw, 20, device="cpu",
                               table_free=True)
    got = ShardedPianoEngine(n, eb, batch, raw, 20, _cpu_mesh(8),
                             table_free=True)
    for e in (ref, single, got):
        e.preprocessing(rng=np.random.default_rng(6))
    assert "table" not in got.state and "rk" in got.state
    P = got.config.partition_num
    assert [st["rk"].shape[0] for st in got.shard_states] == [P // 8] * 8
    ids = [int(i * single.config.partition_size + 3) for i in range(P)] * 2
    assert np.array_equal(_query_all((ref, single, got), ids), raw[ids])
    _assert_state(ref, got)
    _assert_same(single, got)


@pytest.fixture(scope="module")
def trio():
    """n = 4,096 (P = 16), prepped from one seed: the JAX sharded engine on
    8 devices, the port's single engine and its 8-shard engine."""
    rng = np.random.default_rng(71)
    n, eb, batch = 4096, 32, 32
    raw = rng.integers(0, 2**32, size=(n, 8), dtype=np.uint32)
    ref = JaxSharded(n, eb, batch, raw, 20, jmake_mesh(8))
    single = DevicePianoEngine(n, eb, batch, raw, 20, device="cpu")
    got = ShardedPianoEngine(n, eb, batch, raw, 20, _cpu_mesh(8))
    for e in (ref, single, got):
        e.preprocessing(rng=np.random.default_rng(5))
    return raw, ref, single, got


def test_sharded_matches_single_chip(trio):
    """Same seeds -> identical state evolution and answers: the port's
    sharded engine, its single engine and the JAX sharded engine."""
    raw, ref, single, got = trio
    _assert_state(ref, got)
    _assert_same(single, got)
    ids = [int(i * single.config.partition_size + 3)
           for i in range(single.config.partition_num)] * 2
    assert np.array_equal(_query_all((ref, single, got), ids), raw[ids])
    _assert_state(ref, got)
    _assert_same(single, got)
    assert got.consumed() == single.consumed()


def test_load_state_splits_a_jax_sharded_state(trio):
    """convert.load_state carries the JAX sharded engine's state (global
    arrays) into a fresh port sharded engine, each shard taking only its
    partitions; the next batch then matches the JAX engine's."""
    raw, ref, _, prepped = trio
    got = ShardedPianoEngine(4096, 32, 32, raw, 20, _cpu_mesh(8))
    load_state(got, jax.device_get(ref.state))
    per = got.config.partition_num // 8
    assert all(st["table"].shape[0] == per for st in got.shard_states)
    got.queries_made_in_partition = ref.queries_made_in_partition
    ids = [int(i * 256 + 17) for i in range(16)] * 2
    assert np.array_equal(_query_all((ref, got), ids, seed=12), raw[ids])
    _assert_state(ref, got)


def _fused_searches(n_dev):
    """Fused searches over n = 1,024 integer-valued vectors (m = 8: P = 8
    partitions), each engine prepped from one seed: JAX's over its
    n_dev-device sharded engine, the port's over its n_dev-shard engine and
    over its single engine."""
    rng = np.random.default_rng(40)
    n, d, m = 1024, 8, 8
    vectors = rng.integers(0, 8, size=(n, d)).astype(np.float32)
    graph = rng.integers(0, n, size=(n, m)).astype(np.int64)
    raw = pack_vertex_db(vectors, graph)
    sids = np.arange(32)
    engines = (JaxSharded(n, 4 * (d + m), m, raw, 8, jmake_mesh(n_dev)),
               ShardedPianoEngine(n, 4 * (d + m), m, raw, 8,
                                  _cpu_mesh(n_dev)),
               DevicePianoEngine(n, 4 * (d + m), m, raw, 8, device="cpu"))
    out = []
    for e, search in zip(engines, (JaxSearch, FusedPrivateSearch,
                                   FusedPrivateSearch)):
        e.preprocessing(rng=np.random.default_rng(7))
        out.append(search(e, sids, vectors[sids], graph[sids], dim=d, m=m,
                          n=n))
    return (*out, rng.integers(0, 8, size=(2, d)).astype(np.float32))


def _jax_randoms(fs, Qn, max_step, parallel, seed):
    e = fs.engine
    P = e.config.partition_num
    keys = jax.random.split(jax.random.PRNGKey(seed), max_step)
    rand_all, rnd_all = _draw_step_randoms(
        keys, Qn=Qn, parallel=parallel, m=fs.m, n=fs.n,
        quota=Qn * parallel * fs.m // P, P=P, S=e.params.set_size,
        C=e.params.chunk_size)
    return np.asarray(rand_all), np.asarray(rnd_all)


def _search_both(ref, got, q, max_step, parallel, seed):
    want = ref.search(q, k=5, max_step=max_step, parallel=parallel,
                      seed=seed)
    have = got.search(q, k=5, max_step=max_step, parallel=parallel,
                      step_randoms=_jax_randoms(ref, q.shape[0], max_step,
                                                parallel, seed))
    assert np.array_equal(have, want)
    assert np.array_equal(got.fetch_stats, ref.fetch_stats)
    assert got.refreshes == ref.refreshes
    _assert_state(ref.engine, got.engine)
    return have


def test_fused_search_over_sharded_engine_bit_identical():
    """The fused private search over a 4-shard partition-sharded engine,
    JAX's draws fed in: the same answers, fetch counters and state as the
    JAX search over its 4-device engine, and as over the single engine."""
    ref, got, single, q = _fused_searches(4)
    assert got.engine.mesh.size == 4
    ids = _search_both(ref, got, q, 4, 2, 3)
    assert (ids >= 0).any()
    assert np.array_equal(single.search(
        q, k=5, max_step=4, parallel=2,
        step_randoms=_jax_randoms(ref, 2, 4, 2, 3)), ids)
    _assert_same(single.engine, got.engine)


def test_sharded_engine_pallas_route_exact():
    """The "pallas" route (K4's plain version per shard) against the JAX
    sharded engine's Pallas claim in interpret mode: exact answers, equal
    state."""
    rng = np.random.default_rng(73)
    n, eb, batch = 8192, 32, 32
    raw = rng.integers(0, 2**32, size=(n, 8), dtype=np.uint32)
    ref = JaxSharded(n, eb, batch, raw, 20, jmake_mesh(8),
                     kernel_route="pallas")
    got = ShardedPianoEngine(n, eb, batch, raw, 20, _cpu_mesh(8),
                             kernel_route="pallas")
    ref.preprocessing(rng=np.random.default_rng(102))
    got.preprocessing(rng=np.random.default_rng(102))
    c = got.config
    ids = [int(i * c.partition_size + rng.integers(0, c.partition_size))
           for i in range(c.partition_num)]
    assert np.array_equal(_query_all((ref, got), ids), raw[ids])
    _assert_state(ref, got)


@pytest.mark.parametrize("route", ["xla", "pallas"])
def test_chunk_sharded_matches_single_chip(route):
    """ChunkShardedPianoEngine (P = 2 < 8 shards; S sharded, the XOR
    all-reduce) equals the JAX chunk-sharded engine and the port's single
    engine bit for bit: state after prep, answers and state over three
    batches, the budget; each DB shard holds S / 8 chunks."""
    rng = np.random.default_rng(80)
    n, eb, batch = 4096, 32, 4
    raw = rng.integers(0, 2**32, size=(n, 8), dtype=np.uint32)
    ref = JaxChunkSharded(n, eb, batch, raw, 20, jmake_mesh(8))
    single = DevicePianoEngine(n, eb, batch, raw, 20, device="cpu",
                               kernel_route=route)
    got = ChunkShardedPianoEngine(n, eb, batch, raw, 20, _cpu_mesh(8),
                                  kernel_route=route)
    for e in (ref, single, got):
        e.preprocessing(rng=np.random.default_rng(100))
    S = got.params.set_size
    assert [db.shape[0] for db in got.db] == [S // 8] * 8
    _assert_state(ref, got)
    _assert_same(single, got)
    qrng = np.random.default_rng(8)
    for _ in range(3):
        ids = [int(i) for i in qrng.integers(0, n, batch)]
        _query_all((ref, single, got), ids)
    _assert_state(ref, got)
    _assert_same(single, got)
    assert got.queries_made_in_partition == single.queries_made_in_partition


def test_chunk_sharded_rejects_indivisible_mesh():
    rng = np.random.default_rng(81)
    raw = rng.integers(0, 2**32, size=(4096, 8), dtype=np.uint32)
    with pytest.raises(ValueError, match="divisible"):
        JaxChunkSharded(4096, 32, 4, raw, 20, jmake_mesh(3))
    with pytest.raises(ValueError, match="divisible"):
        ChunkShardedPianoEngine(4096, 32, 4, raw, 20, _cpu_mesh(3))
    with pytest.raises(ValueError, match="divisible"):
        ShardedPianoEngine(4096, 32, 32, raw, 20, _cpu_mesh(3))
