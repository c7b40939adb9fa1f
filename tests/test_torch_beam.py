"""The port's plaintext beam search (graph/beam.py, graph/beam_host.py)
against the JAX package's: PlaintextEngine and search_paths_all bit-equal
on integer-valued vectors with JAX's own random draws fed in, recall on
float data, the host twin, and the default device."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pacmann_tpu.graph import beam as jbeam
from pacmann_tpu.graph import beam_host as jhost
from pacmann_tpu.graph.build import build_graph
from pacmann_tpu.graph.recall import compute_recall
from pacmann_tpu_torch.graph import beam, beam_host

torch.set_num_threads(1)

N, D, M = 1024, 16, 8


@pytest.fixture(scope="module")
def data():
    """Integer vectors in 0..7 (many equal distances, so tie order counts)
    and a graph from the JAX package's build_graph."""
    rng = np.random.default_rng(1)
    vecs = rng.integers(0, 8, (N, D)).astype(np.float32)
    graph = np.asarray(build_graph(vecs, M, rounds=2, seed=1))
    queries = rng.integers(0, 8, (24, D)).astype(np.float32)
    return vecs, graph, queries


def _draws(keys, n, max_step, parallel, m):
    """JAX's step draws for one key per query, as _plaintext_search and
    search_paths_all make them: split(key, max_step)[s], then randint."""
    def one(key):
        return jax.vmap(lambda k: jax.random.randint(
            k, (parallel, m), 0, n, dtype=jnp.int32))(
                jax.random.split(key, max_step))
    return np.asarray(jax.vmap(one)(keys))


def _search_pair(vecs, graph, queries, *, k, max_step, parallel, seed=0,
                 benchmarking=False):
    ref = jbeam.PlaintextEngine(vecs, graph).search(
        queries, k, max_step, parallel, seed=seed, benchmarking=benchmarking)
    rand = _draws(jax.random.split(jax.random.PRNGKey(seed), len(queries)),
                  graph.shape[0], max_step, parallel, graph.shape[1])
    got = beam.PlaintextEngine(vecs, graph, device="cpu").search(
        queries, k, max_step, parallel, benchmarking=benchmarking,
        step_randoms=rand)
    return ref, got


@pytest.mark.parametrize("benchmarking", [False, True])
def test_engine_matches_jax(data, benchmarking):
    vecs, graph, queries = data
    (ri, rs), (gi, gs) = _search_pair(vecs, graph, queries, k=10,
                                      max_step=12, parallel=3,
                                      benchmarking=benchmarking)
    assert gi.dtype == np.int32 and gi.shape == (24, 10)
    assert np.array_equal(gi, ri) and np.array_equal(gs, rs)
    if benchmarking:
        assert np.all(gi == -1) and np.all(gs == -1)
    else:
        assert np.all(gi >= 0)


def test_engine_matches_jax_with_empty_frontiers():
    """A sparse random graph (half the rows all zero, i.e. failed fetches)
    empties frontiers, so random ids pad the fetches: still bit-equal."""
    rng = np.random.default_rng(7)
    n = 600
    vecs = rng.integers(0, 256, (n, 32)).astype(np.float32)
    graph = rng.integers(0, n, (n, 4))
    graph[rng.random(n) < 0.5] = 0
    queries = rng.integers(0, 256, (9, 32)).astype(np.float32)
    (ri, rs), (gi, gs) = _search_pair(vecs, graph, queries, k=7,
                                      max_step=15, parallel=2, seed=3)
    assert np.array_equal(gi, ri) and np.array_equal(gs, rs)


def test_search_paths_all_matches_jax(data):
    """n = 1024 over blocks of 300: the last block is partial."""
    vecs, graph, _ = data
    max_step, parallel, block = 6, 2, 300
    key = jax.random.PRNGKey(5)
    start = np.arange(32)
    ref = np.asarray(jbeam.search_paths_all(
        jnp.asarray(vecs), jnp.asarray(graph, jnp.int32),
        jnp.asarray(start, jnp.int32), key, n=N, m=M, max_step=max_step,
        parallel=parallel, block=block))
    nblocks = -(-N // block)
    rand = np.concatenate([
        _draws(jax.random.split(jax.random.fold_in(key, b), block), N,
               max_step, parallel, M) for b in range(nblocks)])[:N]
    got = beam.search_paths_all(
        torch.from_numpy(vecs), torch.from_numpy(graph.astype(np.int32)),
        torch.from_numpy(start), rand, n=N, m=M, max_step=max_step,
        parallel=parallel, block=block)
    assert got.shape == ref.shape == (N, max_step * parallel)
    assert np.array_equal(got.numpy(), ref)
    # without JAX's draws the port draws its own: same shape, valid ids
    own = beam.search_paths_all(
        torch.from_numpy(vecs), torch.from_numpy(graph.astype(np.int32)),
        torch.from_numpy(start), n=N, m=M, max_step=max_step,
        parallel=parallel, block=block, seed=1)
    assert own.shape == got.shape
    assert ((own >= -1) & (own < N)).all() and (own[:, 0] >= 0).all()


def test_float_recall_within_jax(data):
    """Real-valued vectors: rounding may differ from XLA's, so the check
    is recall@10 within 0.02 of the JAX engine's, same draws."""
    vecs, graph, _ = data
    rng = np.random.default_rng(11)
    fvecs = vecs + rng.random(vecs.shape, dtype=np.float32)
    queries = rng.random((64, D), dtype=np.float32) * 8
    d = ((queries[:, None, :] - fvecs[None, :, :]) ** 2).sum(-1)
    gnd = np.argsort(d, axis=1)[:, :10]
    (ri, _), (gi, _) = _search_pair(fvecs, graph, queries, k=10,
                                    max_step=12, parallel=3)
    r_ref, r_got = compute_recall(gnd, ri, 10), compute_recall(gnd, gi, 10)
    assert r_ref > 0.5, r_ref
    assert abs(r_got - r_ref) <= 0.02, (r_got, r_ref)


def test_beam_host_matches_jax_twin(data):
    vecs, graph, queries = data
    out = []
    for mod in (jhost, beam_host):
        s = mod.BeamSearcher(mod.BasicGraphOracle(vecs, graph),
                             np.random.default_rng(4))
        s.preprocess()
        out.append(s.search_knn_batch(queries[:6], 10, 8, 2)
                   + s.search_knn_concurrent(queries[6:12], 10, 8, 2))
    for a, b in zip(*out):
        assert np.array_equal(a, b)


def test_numpy_vectors_default_to_cuda(monkeypatch, data):
    """Numpy vectors with no device go to CUDA: without CUDA the engine
    raises and never lands on the CPU. Tensors keep their device."""
    vecs, graph, _ = data
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        beam.PlaintextEngine(vecs, graph)
    e = beam.PlaintextEngine(torch.from_numpy(vecs), graph)
    assert e.device.type == "cpu" and e.graph.device.type == "cpu"
    assert beam.PlaintextEngine(vecs, graph, device="cpu").device.type \
        == "cpu"
