"""The port's private-search building blocks against the JAX package's, on
the CPU: the entry packing (numpy and device twins, bit for bit on any f32
bit pattern), the report text, PIRGraphOracle on every engine (start ids,
fetched entries, success counters and the engine's client state), and
choose_start_ids with JAX's initial centroid draw fed in."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from pacmann_tpu.graph import build as jbuild
from pacmann_tpu.graph.build import build_graph
from pacmann_tpu.io.report import PrivateSearchReport as JaxReport
from pacmann_tpu.private import oracle as joracle
from pacmann_tpu_torch.graph import build
from pacmann_tpu_torch.io.report import PrivateSearchReport
from pacmann_tpu_torch.pir.convert import state_to_numpy
from pacmann_tpu_torch.private import oracle

torch.set_num_threads(1)

N, D, M = 1024, 16, 8


@pytest.fixture(scope="module")
def data():
    """Float vectors, a graph from the JAX package's build_graph, and the
    batches of ids the oracles are asked for."""
    rng = np.random.default_rng(4)
    vecs = rng.random((N, D), dtype=np.float32)
    graph = np.asarray(build_graph(vecs, M, rounds=3, seed=4), np.int64)
    batches = [rng.integers(0, N, 3 * M) for _ in range(4)]
    return vecs, graph, batches


def _f32_patterns(rng, shape):
    """f32 values over every bit pattern class: random bits (NaNs with
    payloads, infinities, negatives), and explicit -0.0, denormals, NaN."""
    bits = rng.integers(0, 2**32, size=shape, dtype=np.uint32)
    flat = bits.reshape(-1)
    flat[:8] = [0x80000000, 0x00000001, 0x007FFFFF, 0x807FFFFF,
                0x7FC00001, 0xFFC00000, 0x7F800000, 0xBF800000]
    return bits.view("<f4")


def test_pack_vertex_db_bit_for_bit():
    rng = np.random.default_rng(0)
    vecs = _f32_patterns(rng, (64, D))
    graph = rng.integers(0, 2**32, size=(64, M), dtype=np.int64)
    graph[0] = [0, 1, 2**31 - 1, 2**31, 2**32 - 1, 5, 6, 7]
    want = joracle.pack_vertex_db(vecs, graph)
    got = oracle.pack_vertex_db(vecs, graph)
    assert got.dtype == want.dtype == np.uint32
    assert np.array_equal(got, want)
    (gv, gn), (rv, rn) = (oracle.unpack_entries(got, D, M),
                          joracle.unpack_entries(want, D, M))
    assert gv.dtype == rv.dtype and gn.dtype == rn.dtype
    assert np.array_equal(gv.view(np.uint32), rv.view(np.uint32))
    assert np.array_equal(gv.view(np.uint32), vecs.view(np.uint32))
    assert np.array_equal(gn, rn) and np.array_equal(gn, graph)


def test_pack_vertex_db_device_bit_for_bit():
    rng = np.random.default_rng(1)
    vecs = _f32_patterns(rng, (64, D))
    graph = rng.integers(0, 2**31, size=(64, M), dtype=np.int64)
    graph[0, :3] = [0, 2**31 - 1, 12345]
    want = np.asarray(joracle.pack_vertex_db_device(vecs, graph))
    got = oracle.pack_vertex_db_device(torch.from_numpy(vecs.copy()),
                                       torch.from_numpy(graph))
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    assert np.array_equal(got.numpy().view(np.uint32), want)
    assert np.array_equal(want, oracle.pack_vertex_db(vecs, graph))
    # ids at and above 2^31 keep their low 32 bits, as the numpy cast does
    big = np.array([[2**31, 2**32 - 1, 2**32 + 3, 7]], np.int64)
    v1 = np.zeros((1, 2), np.float32)
    got = oracle.pack_vertex_db_device(torch.from_numpy(v1),
                                       torch.from_numpy(big))
    assert np.array_equal(got.numpy().view(np.uint32)[:, 2:],
                          (big & 0xFFFFFFFF).astype(np.uint32))


REPORTS = [
    dict(vector_num=1_000_000, db_size_bytes=640e6, top_k=10, rounds=20,
         parallel=3, rtt_ms=50.0, window_size=23, storage_bytes=123456789.0,
         prep_time_s=0.3125, offline_comm_per_batch_bytes=927536.0,
         maintain_time_per_q_s=0.0135869, avg_compute_time_per_q_s=0.2501,
         online_comm_per_batch_bytes=3968.0, recall=0.9395,
         extra_storage_bytes=99.3e6),
    dict(vector_num=1024, db_size_bytes=98304.0, top_k=5, rounds=6,
         parallel=2, rtt_ms=12.5, window_size=1, storage_bytes=0.0,
         prep_time_s=0.0, offline_comm_per_batch_bytes=0.0,
         maintain_time_per_q_s=0.0, avg_compute_time_per_q_s=1e-7,
         online_comm_per_batch_bytes=0.0),
]


@pytest.mark.parametrize("fields", REPORTS)
def test_report_text_matches_jax(fields, tmp_path):
    got, want = PrivateSearchReport(**fields), JaxReport(**fields)
    assert got.render() == want.render()
    assert got.avg_total_time_per_q_s == want.avg_total_time_per_q_s
    for rep, name in ((got, "port.txt"), (want, "jax.txt")):
        rep.append_to(str(tmp_path / name))
        rep.append_to(str(tmp_path / name))
    assert ((tmp_path / "port.txt").read_text()
            == (tmp_path / "jax.txt").read_text() == 2 * want.render())
    assert ([f.name for f in dataclasses.fields(PrivateSearchReport)]
            == [f.name for f in dataclasses.fields(JaxReport)])


def _engine_state(pir):
    """The client state of any engine as numpy arrays by name."""
    if hasattr(pir, "state") and isinstance(pir.state, dict):
        return {k: np.asarray(v).astype(np.uint32) if not isinstance(
            v, torch.Tensor) else state_to_numpy({k: v})[k]
            for k, v in pir.state.items()}
    if hasattr(pir, "clients"):
        clients = pir.clients
    else:
        clients = [s.client for s in pir.sub_pir]
    out = {}
    for i, cl in enumerate(clients):
        for f in dataclasses.fields(cl.state):
            out[f"{i}.{f.name}"] = np.asarray(getattr(cl.state, f.name))
        out[f"{i}.cache"] = np.array(sorted(cl.cache))
    return out


def _assert_same_engine(ref, got):
    want, have = _engine_state(ref.pir), _engine_state(got.pir)
    assert sorted(have) == sorted(want)
    for key in want:
        assert np.array_equal(have[key].astype(np.uint32),
                              want[key].astype(np.uint32)), key
    for name in ("finished_batch_num", "queries_made_in_partition",
                 "support_batch_num", "comm_cost_per_batch_offline"):
        assert getattr(got.pir, name) == getattr(ref.pir, name), name
    assert got.pir.local_storage_size() == ref.pir.local_storage_size()
    assert got.pir.extra_storage_size() == ref.pir.extra_storage_size()
    assert (got.pir.comm_cost_per_batch_online()
            == ref.pir.comm_cost_per_batch_online())


def _oracles(vecs, graph, **kw):
    ref = joracle.PIRGraphOracle(vecs, graph,
                                 rng=np.random.default_rng(11), **kw)
    got = oracle.PIRGraphOracle(vecs, graph, device="cpu",
                                rng=np.random.default_rng(11), **kw)
    ref.preprocess()
    got.preprocess()
    return ref, got


@pytest.mark.parametrize("engine,skip_prep,non_private", [
    ("simple", False, False), ("fused", False, False),
    ("device", False, False), ("fused", True, False),
    ("device", True, False), ("simple", False, True)])
def test_oracle_matches_jax(data, engine, skip_prep, non_private):
    """Start ids, every fetched entry, the success counters and the engine
    state after prep and after each fetch."""
    vecs, graph, batches = data
    ref, got = _oracles(vecs, graph, engine=engine, skip_prep=skip_prep,
                        non_private=non_private)
    assert type(got.pir).__name__ == type(ref.pir).__name__
    assert got.get_metadata() == ref.get_metadata() == (N, D, M)
    _assert_same_engine(ref, got)
    for a, b in zip(got.get_start_vertices(), ref.get_start_vertices()):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert got.rng.bit_generator.state == ref.rng.bit_generator.state
    for ids in batches:
        (gv, gn), (rv, rn) = got.get_vertex_info(ids), ref.get_vertex_info(ids)
        assert np.array_equal(gv.view(np.uint32), rv.view(np.uint32))
        assert gn.dtype == rn.dtype and np.array_equal(gn, rn)
        assert got.total_query_num == ref.total_query_num
        assert got.succ_query_num == ref.succ_query_num
        _assert_same_engine(ref, got)
    assert got.success_rate() == ref.success_rate()
    if skip_prep:
        assert got.succ_query_num == 0
    elif not non_private:
        assert got.succ_query_num > 0


def _jax_init_ids(n, n_starts, seed=0):
    """choose_start_ids' initial centroid ids as the JAX package draws them."""
    return np.asarray(jax.random.randint(jax.random.PRNGKey(seed),
                                         (n_starts,), 0, n, np.int32))


def _clustered(rng, init, n, d=D):
    """n integer-valued points in cells far apart, one a distinct id of
    init, each holding its id: a core point, pairs mirrored about it (core
    ± small integers) and copies of the core, so that its mean is its core
    exactly. Every distance is an exact integer in f32 and the cells have a
    margin, so no float rounding can move a point to another cell; the core
    (its first copy) is the nearest vertex of a cell's mean."""
    init = np.array(list(dict.fromkeys(np.asarray(init).tolist())))
    cores = rng.integers(0, 8, (len(init), d)) * 64
    rest = rng.permutation(np.setdiff1d(np.arange(n), init))
    members = [[j] for j in init]
    for i, idx in enumerate(rest):
        members[i % len(init)].append(idx)
    v = np.zeros((n, d), np.float32)
    for c, idx in enumerate(members):
        idx = rng.permutation(idx)
        vals = [cores[c]]
        while len(vals) + 1 < len(idx):
            off = rng.integers(-3, 4, d)
            vals += [cores[c] + off, cores[c] - off]
        vals += [cores[c]] * (len(idx) - len(vals))
        v[idx] = vals
    return v


def test_oracle_centroid_starts_match_jax(data, monkeypatch):
    """start_mode="centroid" with JAX's initial draw handed to the port's
    choose_start_ids: the same start set, on clustered integer data."""
    graph = data[1]
    init = _jax_init_ids(N, int(np.sqrt(N)))
    vecs = _clustered(np.random.default_rng(5), init, N)
    real = build.choose_start_ids
    monkeypatch.setattr(build, "choose_start_ids",
                        lambda v, k, **kw: real(v, k, init_ids=init, **kw))
    ref, got = _oracles(vecs, graph, engine="simple", start_mode="centroid")
    for a, b in zip(got.get_start_vertices(), ref.get_start_vertices()):
        assert np.array_equal(a, b)


def test_choose_start_ids_matches_jax():
    """One initial centroid in every cell: Lloyd keeps each in its cell and
    moves it to the cell's core; the ids are the cores'."""
    n, n_cells = 984, 24
    init = _jax_init_ids(n, n_cells, seed=3)
    vecs = _clustered(np.random.default_rng(6), init, n)
    want = jbuild.choose_start_ids(vecs, n_cells, seed=3, block=256)
    got = build.choose_start_ids(vecs, n_cells, seed=3, block=256,
                                 init_ids=init, device="cpu")
    assert got.dtype == want.dtype == np.int64
    assert np.array_equal(got, want)
    assert len(np.unique(got)) == n_cells
    assert not np.array_equal(np.sort(got), np.sort(init))


def test_choose_start_ids_tops_up_duplicates_as_jax():
    """Cells of identical points, fewer cells than starts: several
    centroids resolve to one vertex (the lowest id of its cell), and the
    numpy top-up fills the rest with the JAX package's draws."""
    rng = np.random.default_rng(7)
    n, n_starts, n_cells = 700, 26, 9
    init = _jax_init_ids(n, n_starts, seed=5)
    cell = rng.integers(0, n_cells, n)
    cell[init] = np.arange(n_starts) % n_cells
    assert len(np.unique(cell[init])) == n_cells   # a centroid in each cell
    vecs = (rng.integers(0, 50, (n_cells, D)) * 8)[cell].astype(np.float32)
    want = jbuild.choose_start_ids(vecs, n_starts, seed=5, block=128)
    got = build.choose_start_ids(vecs, n_starts, seed=5, block=128,
                                 init_ids=init, device="cpu")
    assert np.array_equal(got, want)
    assert len(np.unique(got)) == n_starts


def test_choose_start_ids_own_draw():
    """Without init_ids the port draws from a torch generator seeded with
    `seed`: distinct ids in range, the same for the same seed; a tensor
    input stays on its device."""
    vecs = _clustered(np.random.default_rng(8), np.arange(16) * 21, 336)
    a = build.choose_start_ids(vecs, 20, seed=1, device="cpu")
    b = build.choose_start_ids(torch.from_numpy(vecs), 20, seed=1)
    assert np.array_equal(a, b)
    assert len(np.unique(a)) == 20 and ((a >= 0) & (a < len(vecs))).all()


def test_oracle_default_device_is_cuda(data, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    vecs, graph, _ = data
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        oracle.PIRGraphOracle(vecs, graph)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build.choose_start_ids(vecs, 4)
