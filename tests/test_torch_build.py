"""The port's graph build (graph/build.py) against the JAX package's, on the
CPU. Each stage bit-exact on integer-valued vectors (every f32 distance
exact) with JAX's random draws handed in, rebuilt from its split/fold_in
chain per block and concatenated in row order; the whole build on quality
parity; twins of the JAX package's build tests."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pacmann_tpu.graph import build as jbuild
from pacmann_tpu.graph.beam import PlaintextEngine as JEngine
from pacmann_tpu.graph.recall import evaluate_graph_quality as jgate
from pacmann_tpu_torch.graph import build
from pacmann_tpu_torch.graph.beam import PlaintextEngine
from pacmann_tpu_torch.graph.recall import (brute_force_knn, compute_recall,
                                            evaluate_graph_quality)

torch.set_num_threads(2)


def _t(x):
    return torch.from_numpy(np.asarray(x).astype(np.int64)) \
        if np.asarray(x).dtype.kind in "iu" else torch.from_numpy(
            np.asarray(x, np.float32))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _bits(key, shape):
    return np.asarray(jax.random.bits(key, shape, jnp.uint32)).astype(
        np.int64)


def _int_vectors(rng, n, d, hi=8):
    return rng.integers(0, hi, (n, d)).astype(np.float32)


def _per_block(fn, key, nblocks):
    """JAX's per-block draws fn(fold_in(key, b)), concatenated in row
    order."""
    return np.concatenate([np.asarray(fn(jax.random.fold_in(key, b)))
                           for b in range(nblocks)])


def _round_draws(key, npad, m, block, *, nsn, n_random, n_real, wide):
    """The draws of JAX's _nn_round_device(key), row i for vertex i."""
    k_rev, k_blocks = jax.random.split(key)
    nb = npad // block
    rand = {"rnd": _per_block(lambda kb: jax.random.randint(
        jax.random.fold_in(kb, 2), (block, n_random), 0, n_real, jnp.int32),
        k_blocks, nb)}
    if not wide:
        k_tie, k_fill = jax.random.split(k_rev)
        rand["tie"] = _bits(k_tie, (npad * m,))
        rand["fill"] = np.asarray(jax.random.randint(
            k_fill, (npad, nsn), 0, n_real, jnp.int32))
        rand["pick"] = _per_block(lambda kb: jax.random.randint(
            jax.random.fold_in(kb, 1), (block, m, nsn), 0, m, jnp.int32),
            k_blocks, nb)
        rand["rpick"] = _per_block(lambda kb: jax.random.randint(
            jax.random.fold_in(kb, 3), (block, nsn, nsn * 2), 0, m,
            jnp.int32), k_blocks, nb)
    return {k: _t(v) for k, v in rand.items()}


@pytest.fixture
def small_chunks(monkeypatch):
    """Passes of a few rows at a time: results must not change."""
    monkeypatch.setitem(build.CHUNK_BYTES, "cpu", 40_000)


def test_select_topk_sorted_matches_jax():
    rng = np.random.default_rng(0)
    n, d, B, C = 300, 12, 40, 50
    v = _int_vectors(rng, n, d)
    sqn = (v * v).sum(1)
    ids = rng.choice(n, B, replace=False)
    cand = rng.integers(0, n, (B, C))
    cand[:, :5] = cand[:, 5:10]              # duplicates
    cand[:, 10] = ids                        # self
    want = jbuild._select_topk_sorted(jnp.asarray(v), jnp.asarray(sqn),
                                      jnp.asarray(v[ids]), jnp.asarray(ids),
                                      jnp.asarray(cand, jnp.int32), 48)
    got = build._select_topk_sorted(_t(v), _t(sqn), _t(v[ids]), _t(ids),
                                    _t(cand), 48)
    assert np.array_equal(_np(got[0]), np.asarray(want[0]))
    assert np.array_equal(_np(got[1]), np.asarray(want[1]))
    assert np.isinf(_np(got[1])).any()


def test_reverse_sample_matches_jax():
    rng = np.random.default_rng(1)
    npad, n_real, m, nsn = 256, 250, 6, 2
    graph = rng.integers(0, npad, (npad, m)).astype(np.int32)
    key = jax.random.PRNGKey(3)
    want = jbuild._reverse_sample_device(jnp.asarray(graph), key, nsn, n_real)
    k_tie, k_fill = jax.random.split(key)
    got = build._reverse_sample_device(
        _t(graph), _t(_bits(k_tie, (npad * m,))),
        _t(jax.random.randint(k_fill, (npad, nsn), 0, n_real, jnp.int32)),
        nsn, n_real)
    assert np.array_equal(_np(got), np.asarray(want))


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("chunks", ["whole", "small"])
def test_nn_round_matches_jax(wide, chunks, request):
    """Four JAX blocks of 128 rows, the last 20 rows padding."""
    if chunks == "small":
        request.getfixturevalue("small_chunks")
    rng = np.random.default_rng(2)
    npad, n_real, d, m, block = 512, 492, 10, 8, 128
    v = _int_vectors(rng, npad, d)
    v[n_real:] = v[0]
    sqn = (v * v).sum(1)
    graph = rng.integers(0, n_real, (npad, m)).astype(np.int32)
    key = jax.random.PRNGKey(4)
    out_m = 20 if wide else m
    n_random = 16 if wide else 8
    want = jbuild._nn_round_device(
        jnp.asarray(v), jnp.asarray(sqn), jnp.asarray(graph), key, nsn=2,
        n_random=n_random, block=block, n_real=n_real, out_m=out_m,
        wide=wide)
    rand = _round_draws(key, npad, m, block, nsn=2, n_random=n_random,
                        n_real=n_real, wide=wide)
    got = build._nn_round_device(_t(v), _t(sqn), _t(graph), rand, nsn=2,
                                 n_random=n_random, n_real=n_real,
                                 out_m=out_m, wide=wide)
    assert np.array_equal(_np(got[0]), np.asarray(want[0]))
    assert np.array_equal(_np(got[1]), np.asarray(want[1]))


def test_single_wide_round_matches_jax_sliced():
    """The port runs the single wide round for every n; JAX's big builds
    run it in 8 slice programs merged pairwise. Same distances and id
    sets, only top-k tie order may differ (test_build_device.py's check),
    on real-valued data."""
    rng = np.random.default_rng(5)
    n, d, m, blk, out_m = 2048, 24, 16, 256, 24
    v = rng.standard_normal((n, d)).astype(np.float32)
    sqn = (v * v).sum(1)
    g = rng.integers(0, n, size=(n, m)).astype(np.int32)
    key = jax.random.PRNGKey(3)
    i8, d8 = map(np.asarray, jbuild._wide_round_sliced(
        jnp.asarray(v), jnp.asarray(sqn), jnp.asarray(g), key, n_random=16,
        block=blk, n_real=n, out_m=out_m, parts=8))
    rand = _round_draws(key, n, m, blk, nsn=2, n_random=16, n_real=n,
                        wide=True)
    i1, d1 = map(_np, build._nn_round_device(
        _t(v), _t(sqn), _t(g), rand, nsn=2, n_random=16, n_real=n,
        out_m=out_m, wide=True))
    s1, s8 = np.sort(d1, axis=1), np.sort(d8, axis=1)
    fin = np.isfinite(s1)
    assert (np.isfinite(s8) == fin).all()
    assert np.allclose(s1[fin], s8[fin], atol=1e-4)
    for r in range(n):
        assert (set(i1[r][np.isfinite(d1[r])])
                == set(i8[r][np.isfinite(d8[r])]))


def _prune_inputs(seed, B=48, C=40, n=200, d=8):
    rng = np.random.default_rng(seed)
    v = _int_vectors(rng, n, d, hi=5)       # many equal distances
    u = rng.choice(n, B, replace=False)
    cand = rng.integers(0, n, (B, C))
    cand[:, 20:30] = cand[:, :10]            # duplicate ids
    valid = rng.random((B, C)) < 0.85
    return v, u, cand, valid


@pytest.mark.parametrize("keep", [0, 16])
def test_robust_prune_batch_matches_jax(keep):
    v, u, cand, valid = _prune_inputs(6)
    want = jbuild._robust_prune_batch(
        jnp.asarray(v), jnp.asarray(u, jnp.int32),
        jnp.asarray(cand, jnp.int32), jnp.asarray(valid), 12, keep=keep)
    got = build._robust_prune_batch(_t(v), _t(u), _t(cand),
                                    torch.from_numpy(valid), 12, keep=keep)
    assert np.array_equal(_np(got[0]), np.asarray(want[0]))
    assert np.array_equal(_np(got[1]), np.asarray(want[1]))


@pytest.mark.parametrize("chunks", ["whole", "small"])
def test_prune_device_matches_jax(chunks, request):
    if chunks == "small":
        request.getfixturevalue("small_chunks")
    rng = np.random.default_rng(7)
    npad, d, C, m, block = 256, 8, 36, 10, 64
    v = _int_vectors(rng, npad, d, hi=6)
    ids = rng.integers(-1, npad, (npad, C)).astype(np.int32)
    dist = np.where(rng.random((npad, C)) < 0.8, 0.0, np.inf).astype(
        np.float32)
    want = jbuild._prune_device(jnp.asarray(v), jnp.asarray(ids),
                                jnp.asarray(dist), m=m, block=block, keep=4)
    got = build._prune_device(_t(v), _t(ids), _t(dist), m=m, keep=4)
    assert np.array_equal(_np(got), np.asarray(want))


def _conn_case():
    """npad 160 rows, 150 real; -1 slots; hubs over the keep probability's
    1.5m and over the cap."""
    rng = np.random.default_rng(8)
    npad, n_real, mw = 160, 150, 6
    pruned = rng.integers(0, n_real, (npad, mw)).astype(np.int32)
    pruned[rng.random((npad, mw)) < 0.3] = rng.integers(0, 5)  # hubs 0..4
    pruned[rng.random((npad, mw)) < 0.1] = -1
    return pruned, n_real


def _conn_draws(key, E2):
    k1, k2 = jax.random.split(key)
    return (torch.from_numpy(np.array(jax.random.uniform(k1, (E2,)))),
            _t(_bits(k2, (E2,))))


def test_conn_lists_matches_jax():
    pruned, n_real = _conn_case()
    key = jax.random.PRNGKey(9)
    want = jbuild._conn_lists_device(jnp.asarray(pruned), key, n_real=n_real,
                                     m=4, cap=12)
    uni, tie = _conn_draws(key, 2 * pruned.size)
    got = build._conn_lists_device(_t(pruned), uni, tie, n_real=n_real, m=4,
                                   cap=12)
    assert np.array_equal(_np(got[0]), np.asarray(want[0]))
    assert np.array_equal(_np(got[1]), np.asarray(want[1]))
    assert (_np(got[1]) == 12).any()


@pytest.mark.parametrize("cap", [12, 40])
def test_prune_or_keep_matches_jax(cap):
    """cap 40 > 4m narrows hub pools to the 4m nearest first."""
    pruned, n_real = _conn_case()
    rng = np.random.default_rng(10)
    v = _int_vectors(rng, pruned.shape[0], 6, hi=6)
    uni, tie = _conn_draws(jax.random.PRNGKey(11), 2 * pruned.size)
    conn, counts = build._conn_lists_device(_t(pruned), uni, tie,
                                            n_real=n_real, m=4, cap=cap)
    want = jbuild._prune_or_keep_device(
        jnp.asarray(v), jnp.asarray(_np(conn), jnp.int32),
        jnp.asarray(_np(counts), jnp.int32), m=8, block=32, keep=3)
    got = build._prune_or_keep_device(_t(v), conn, counts, m=8, keep=3)
    assert np.array_equal(_np(got), np.asarray(want))


def test_random_fill_device_matches_jax():
    rng = np.random.default_rng(12)
    npad, n_real, m, block = 192, 40, 8, 64
    out = rng.integers(-1, n_real, (npad, m)).astype(np.int32)
    out[:, 3] = np.arange(npad) % n_real     # self edges on real rows
    key = jax.random.PRNGKey(13)
    want = jbuild._random_fill_device(jnp.asarray(out), key, m=m,
                                      block=block, n_real=n_real)
    fill = np.stack([_per_block(
        lambda kb, i=i: jax.random.randint(jax.random.fold_in(kb, i),
                                           (block, m), 0, n_real, jnp.int32),
        key, npad // block) for i in range(build.FILL_ROUNDS)])
    got = build._random_fill_device(_t(out), _t(fill), m=m)
    assert np.array_equal(_np(got), np.asarray(want))


def test_degree_reg_matches_jax():
    pruned, n_real = _conn_case()
    npad = pruned.shape[0]
    rng = np.random.default_rng(14)
    v = _int_vectors(rng, npad, 6)
    key = jax.random.PRNGKey(15)
    want = jbuild._degree_reg_device(jnp.asarray(v), jnp.asarray(pruned),
                                     key, n_real=n_real, m=6, cap=16,
                                     block=32, keep=2)
    kr, kf = jax.random.split(key)
    uni, tie = _conn_draws(kr, 2 * pruned.size)
    fill = np.stack([_per_block(
        lambda kb, i=i: jax.random.randint(jax.random.fold_in(kb, i),
                                           (32, 6), 0, n_real, jnp.int32),
        kf, npad // 32) for i in range(build.FILL_ROUNDS)])
    got = build._degree_reg_device(_t(v), _t(pruned), uni, tie, _t(fill),
                                   n_real=n_real, m=6, cap=16, keep=2)
    assert np.array_equal(_np(got), np.asarray(want))


def test_host_random_fill_matches_jax():
    rng = np.random.default_rng(16)
    n, m = 30, 12                            # dense: stragglers likely
    out = rng.integers(-1, n, (n, m))
    out[rng.random((n, m)) < 0.5] = -1
    r1, r2 = np.random.default_rng(17), np.random.default_rng(17)
    got = build._random_fill(out.copy(), m, r1)
    want = jbuild._random_fill(out.copy(), m, r2)
    assert np.array_equal(got, want)
    assert r1.integers(0, 1 << 40) == r2.integers(0, 1 << 40)
    for u in range(n):
        assert len(set(got[u].tolist())) == m and u not in got[u]


def _bootstrap_case():
    """Four well-separated integer clusters, npad 256, 250 real."""
    rng = np.random.default_rng(18)
    npad, n_real, d = 256, 250, 6
    centers = rng.integers(0, 4, (4, d)) * 100
    v = (centers[rng.integers(0, 4, npad)]
         + rng.integers(0, 5, (npad, d))).astype(np.float32)
    v[n_real:] = v[0]
    return v, n_real


def test_bootstrap_member_pick_matches_jax():
    """Given JAX's labels, the cell sort and the member pick; and the whole
    bootstrap on well-separated integer clusters (the centroids are exact
    means, the argmins far from ties) given JAX's initial centroid ids."""
    v, n_real = _bootstrap_case()
    npad, K, m = v.shape[0], 8, 5
    key = jax.random.PRNGKey(19)
    want = [np.asarray(x) for x in jbuild._kmeans_bootstrap(
        jnp.asarray(v), key, K=K, m=m, iters=2, block=64, n_real=n_real)]
    k_init, k_tie, k_pick = jax.random.split(key, 3)
    tie = _t(_bits(k_tie, (npad,)))
    off = _t(jax.random.randint(k_pick, (npad, m), 0, 1 << 30, jnp.int32))
    init, labels, ids_s, starts, sizes = build._cell_members(
        _t(want[1]), tie, off, K=K, n_real=n_real)
    for g, w in zip((init, labels, ids_s, starts, sizes),
                    (want[0], want[1], want[3], want[4], want[5])):
        assert np.array_equal(_np(g), w)
    init_ids = _t(jax.random.randint(k_init, (K,), 0, n_real, jnp.int32))
    got = build._kmeans_bootstrap(_t(v), init_ids, tie, off, K=K, iters=2,
                                  block=64, n_real=n_real)
    for g, w in zip(got, want):
        assert np.array_equal(_np(g), w)


def test_ladder_matches_jax():
    """The member pick given JAX's ladder cells, and the whole ladder on
    integer-valued centroids (the centroid distances exact)."""
    v, n_real = _bootstrap_case()
    _, labels, cent, ids_s, starts, sizes = jbuild._kmeans_bootstrap(
        jnp.asarray(v), jax.random.PRNGKey(20), K=8, m=4, iters=2,
        block=64, n_real=n_real)
    L, key = 3, jax.random.PRNGKey(21)
    off = jax.random.randint(key, (v.shape[0], L), 0, 1 << 30, jnp.int32)
    for c in (cent, jnp.round(cent)):
        want = jbuild._ladder_candidates(labels, c, ids_s, starts, sizes,
                                         key, L=L)
        # JAX's cells, as _ladder_candidates computes them
        cn = jnp.sum(c * c, axis=1)
        order = jnp.argsort(cn[None, :] - 2.0 * (c @ c.T), axis=1)
        cells = order[:, jnp.minimum(2 ** jnp.arange(L), 7)][
            jnp.minimum(labels, 7)]
        got = build._ladder_pick(_t(cells), _t(ids_s), _t(starts),
                                 _t(sizes), _t(off))
        assert np.array_equal(_np(got), np.asarray(want))
    got = build._ladder_candidates(_t(labels), _t(np.asarray(c)), _t(ids_s),
                                   _t(starts), _t(sizes), _t(off), L=L)
    assert np.array_equal(_np(got), np.asarray(want))


def test_draws_are_named_and_row_keyed():
    """A draw handed in replaces that draw only; the corridor's block
    draws equal one whole draw whatever the blocks; a kept draw comes
    back from made()."""
    dr = build.BuildDraws(3, keep=True)
    a = dr.ints("x", (5, 4), 100, "cpu")
    assert torch.equal(a, build.BuildDraws(3).ints("x", (5, 4), 100, "cpu"))
    assert not torch.equal(a, build.BuildDraws(4).ints("x", (5, 4), 100,
                                                       "cpu"))
    given = build.BuildDraws(3, {"y": np.zeros((5, 4), np.int32)})
    assert torch.equal(given.ints("x", (5, 4), 100, "cpu"), a)
    assert (given.ints("y", (5, 4), 100, "cpu") == 0).all()
    with pytest.raises(ValueError, match="shape"):
        given.ints("y", (4, 5), 100, "cpu")
    rows = dr.step_randoms("c", 10, (3, 2), 50, "cpu")
    whole = rows(0, 10)
    parts = {r0: rows(r0, r1) for r0, r1 in ((7, 10), (0, 3), (3, 7))}
    assert torch.equal(torch.cat([parts[r] for r in (0, 3, 7)]), whole)
    bits = dr.bits("b", (1000,), "cpu")
    assert bits.min() >= 0 and bits.max() < 1 << 32 and bits.max() > 1 << 31
    made = dr.made()
    assert set(made) == {"x", "c", "b"}
    assert torch.equal(made["x"], a) and torch.equal(made["c"], whole)


def _lowbias32(x):
    """The draws' hash in numpy uint64 arithmetic, reduced mod 2^32."""
    x = x.astype(np.uint64)
    m = np.uint64(0xFFFFFFFF)
    x ^= x >> np.uint64(16)
    x = (x * np.uint64(0x7FEB352D)) & m
    x ^= x >> np.uint64(15)
    x = (x * np.uint64(0x846CA68B)) & m
    return x ^ (x >> np.uint64(16))


@pytest.mark.parametrize("seed", [0, 7, (5 << 32) + 9])
def test_draws_are_the_counter_hash(seed):
    """Element i of a default draw is lowbias32(lowbias32(lo(i) ^ k0) ^
    hi(i) ^ k1) (the keys from seed and name), reproduced here in numpy
    uint64 arithmetic, also past 2^32 elements (offset); ints, bits and
    uniforms are its top bits, each roughly uniform."""
    dr = build.BuildDraws(seed)
    k0, k1 = dr._keys("n")
    i = np.arange(5000, dtype=np.uint64) + np.uint64((1 << 32) - 2500)
    m = np.uint64(0xFFFFFFFF)
    want = _lowbias32(_lowbias32((i & m) ^ np.uint64(k0)) ^ (i >> np.uint64(
        32)) ^ np.uint64(k1))
    got = dr._hash("n", (50, 100), "cpu", offset=(1 << 32) - 2500)
    assert np.array_equal(got.reshape(-1).numpy(), want.astype(np.int64))
    ids = dr.ints("n", (5000,), 1000, "cpu").numpy()
    base = dr._hash("n", (5000,), "cpu").numpy()
    assert np.array_equal(ids, (base * 1000) >> 32)
    assert ids.min() >= 0 and ids.max() < 1000
    counts = np.bincount(ids // 100, minlength=10)
    assert counts.min() > 400 and counts.max() < 600
    u = dr.uniform("u", (20000,), "cpu").numpy()
    assert u.dtype == np.float32 and u.min() >= 0 and u.max() < 1
    assert abs(u.mean() - 0.5) < 0.01
    b = dr.bits("b", (20000,), "cpu").numpy()
    assert abs((b >> 31).mean() - 0.5) < 0.02


def _continuum(n, d, rng, latent=16):
    basis = (rng.standard_normal((latent, d)) / np.sqrt(latent)) \
        .astype(np.float32)
    z = rng.standard_normal((n, latent)).astype(np.float32)
    return (z @ basis
            + 0.02 * rng.standard_normal((n, d)).astype(np.float32))


def test_build_quality_parity_with_jax():
    """test_quality_gate.py's workload (continuum, n = 4,096, d = 64, m =
    32, rounds 3, seed 0): the port's recall@10 at least 0.93 and within
    0.03 of JAX's; the self-query gate within 0.05 (hit rate) and 0.5 (avg
    steps) of JAX's; every row m distinct non-self ids."""
    rng = np.random.default_rng(0)
    n, d, m = 4096, 64, 32
    v = _continuum(n, d, rng)
    stats = {}
    got = build.build_graph(v, m, rounds=3, seed=0, quality_gate=True,
                            device="cpu", stats=stats)
    gate = stats["gate"]
    want = np.asarray(jbuild.build_graph(v, m, rounds=3, seed=0,
                                         quality_gate=False))
    Q = 50
    q = v[rng.choice(n, Q, replace=False)] \
        + 0.1 * rng.standard_normal((Q, d)).astype(np.float32)
    gnd = brute_force_knn(v, q, 10, device="cpu")
    r_got = compute_recall(gnd, PlaintextEngine(v, got, device="cpu").search(
        q, 10, 20, 3, seed=1)[0], 10)
    r_want = compute_recall(gnd, JEngine(v, want).search(q, 10, 20, 3,
                                                         seed=1)[0], 10)
    assert r_got >= 0.93 and abs(r_got - r_want) <= 0.03, (r_got, r_want)
    j_hit, j_steps = jgate(v, want, num_queries=100, seed=0)
    assert gate == evaluate_graph_quality(v, got, num_queries=100, seed=0,
                                          device="cpu")
    assert abs(gate[0] - j_hit) <= 0.05 and abs(gate[1] - j_steps) <= 0.5, \
        (gate, j_hit, j_steps)
    assert got.dtype == np.int32 and got.shape == (n, m)
    srt = np.sort(got, axis=1)
    assert (srt[:, 1:] != srt[:, :-1]).all()
    assert not (got == np.arange(n)[:, None]).any()
    assert set(stats["phases"]) >= {
        "bootstrap", "descent 0", "descent 2", "wide", "ladder", "nav prune",
        "corridors", "final prune", "degree reg + fill", "gate"}


def test_graph_degree_invariants():
    """Twin of test_beam.py::test_graph_degree_invariants (n = 2,048, d =
    16, m = 8, rounds 3, seed 11), every row checked."""
    rng = np.random.default_rng(11)
    vectors = rng.random((2048, 16), dtype=np.float32)
    graph = build.build_graph(vectors, 8, rounds=3, seed=11, device="cpu")
    n, m = graph.shape
    assert np.all(graph >= 0) and np.all(graph < n)
    for u in range(n):
        assert len(set(graph[u].tolist())) == m and u not in graph[u]


@pytest.mark.parametrize("block", [2048, 512])
def test_build_graph_n_not_block_multiple(block):
    """Twin of test_beam.py's (n = 1,500); with block 512 the build pads to
    1,536 rows of row-0 copies, and no padded id reaches the graph."""
    rng = np.random.default_rng(5)
    n, m = 1500, 8
    vectors = rng.random((n, 12), dtype=np.float32)
    graph = build.build_graph(vectors, m, rounds=2, seed=5, block=block,
                              device="cpu")
    assert graph.shape == (n, m)
    assert np.all(graph >= 0) and np.all(graph < n)


def test_build_graph_compact_u8_matches_f32():
    """Twin of test_build_device.py's: the u8 input builds the same graph
    as its f32 form; and a tensor input the same as numpy."""
    rng = np.random.default_rng(11)
    v_u8 = rng.integers(0, 256, size=(512, 24), dtype=np.uint8)
    g_u8 = build.build_graph(v_u8, 8, rounds=2, seed=3, device="cpu")
    g_f32 = build.build_graph(v_u8.astype(np.float32), 8, rounds=2, seed=3,
                              device="cpu")
    g_t = build.build_graph(torch.from_numpy(v_u8), 8, rounds=2, seed=3)
    assert np.array_equal(g_u8, g_f32) and np.array_equal(g_u8, g_t)
    assert not np.array_equal(g_u8, build.build_graph(
        v_u8, 8, rounds=2, seed=4, device="cpu"))


def test_build_graph_takes_handed_in_draws():
    """A draw handed to build_graph replaces that draw only: the default
    values handed in give the default graph, other values another."""
    rng = np.random.default_rng(13)
    v = rng.integers(0, 256, size=(300, 16), dtype=np.uint8)
    base = build.build_graph(v, 8, rounds=1, seed=2, device="cpu")
    far = build.BuildDraws(2).ints("far", (300, 8), 300, "cpu").numpy()
    same = build.build_graph(v, 8, rounds=1, seed=2, device="cpu",
                             draws={"far": far})
    other = build.build_graph(v, 8, rounds=1, seed=2, device="cpu",
                              draws={"far": (far + 1) % 300})
    assert np.array_equal(same, base) and not np.array_equal(other, base)


def test_build_graph_takes_kept_draws():
    """The draws a build made and kept, handed to another build as a
    dict, give the same graph (how the card's parity check hands the CPU's
    draws in); the corridor draw comes back whole."""
    rng = np.random.default_rng(14)
    v = rng.integers(0, 256, size=(300, 16), dtype=np.uint8)
    kept = build.BuildDraws(2, keep=True)
    base = build.build_graph(v, 8, rounds=1, seed=2, device="cpu",
                             draws=kept)
    made = kept.made()
    assert made["corridor0"].shape == (300, 16, 2, 8)
    assert {"bootstrap.init", "descent0.tie", "far", "nav_fill",
            "degree.fill"} <= set(made)
    again = build.build_graph(v, 8, rounds=1, seed=2, device="cpu",
                              draws=made)
    assert np.array_equal(again, base)
    assert np.array_equal(base, build.build_graph(v, 8, rounds=1, seed=2,
                                                  device="cpu"))


def test_build_graph_record_replays():
    """Every recorded stage, called again on its recorded inputs, gives
    its recorded output (the replay the card's parity check runs)."""
    rng = np.random.default_rng(12)
    v = rng.integers(0, 256, size=(300, 16), dtype=np.uint8)
    rec = {}
    build.build_graph(v, 8, rounds=1, seed=2, device="cpu", record=rec)
    assert "corridors" in rec and "degree reg + fill" in rec
    for name, (fn, args, kw, out) in rec.items():
        again = fn(*args, **kw)
        outs = out if isinstance(out, tuple) else (out,)
        agains = again if isinstance(again, tuple) else (again,)
        for a, b in zip(outs, agains):
            assert torch.equal(a, b), name


def test_build_graph_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build.build_graph(np.zeros((64, 4), np.float32), 4)
