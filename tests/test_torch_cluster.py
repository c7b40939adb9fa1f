"""The port's cluster baseline (graph/cluster.py, cli/cluster_search.py)
against the JAX package's on the CPU: kmeans and ClusterSearcher bit-exact
given JAX's k-means++ seeding ids (rebuilt from its PRNG chain) on
well-separated integer clusters, the JAX package's two cluster tests as
twins, the command line against JAX's printed recall."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pacmann_tpu.cli import cluster_search as jcli
from pacmann_tpu.graph import cluster as jcluster
from pacmann_tpu.ops.distance import l2_distance_xla
from pacmann_tpu_torch.cli import cluster_search
from pacmann_tpu_torch.graph import cluster
from pacmann_tpu_torch.graph.recall import brute_force_knn, compute_recall
from pacmann_tpu_torch.ops import distance

torch.set_num_threads(2)


def _jax_seed_ids(sample, seed, K):
    """The ids JAX's _kmeanspp_init(sample, PRNGKey(seed), K) takes, by its
    own draws in its order."""
    sample = jnp.asarray(sample)
    key = jax.random.PRNGKey(seed)
    n = sample.shape[0]
    k0 = jax.random.randint(key, (), 0, n)
    min_d = l2_distance_xla(sample[k0][None, :], sample)[0]
    ids = [int(k0)]
    for _ in range(1, K):
        key, sub = jax.random.split(key)
        p = min_d / jnp.maximum(jnp.sum(min_d), 1e-30)
        nxt = jax.random.categorical(sub, jnp.log(p + 1e-30))
        ids.append(int(nxt))
        min_d = jnp.minimum(
            min_d, l2_distance_xla(sample[nxt][None, :], sample)[0])
    got = np.asarray(jcluster._kmeanspp_init(sample, jax.random.PRNGKey(seed),
                                             K))
    assert np.array_equal(got, np.asarray(sample)[ids])
    return np.array(ids)


def _int_clusters(rng, n_clusters=16, per=128, d=8):
    """Well-separated integer clusters: centroids are exact means and no
    argmin is near a tie."""
    centers = rng.integers(0, 8, (n_clusters, d)) * 40
    pts = centers[:, None, :] + rng.integers(0, 6, (n_clusters, per, d))
    return pts.reshape(-1, d).astype(np.float32)


def _clustered_data(rng, n_clusters=16, per=128, d=8):
    centers = rng.standard_normal((n_clusters, d)).astype(np.float32) * 10
    pts = (centers[:, None, :]
           + rng.standard_normal((n_clusters, per, d)).astype(np.float32))
    return pts.reshape(-1, d), centers


def test_kmeans_matches_jax_given_its_seeding():
    rng = np.random.default_rng(3)
    v = _int_clusters(rng)
    ids = _jax_seed_ids(v, 1, 16)
    want_c, want_l = jcluster.kmeans(v, 16, n_iter=6, seed=1, block=512)
    got_c, got_l = cluster.kmeans(v, 16, n_iter=6, seed=1, block=512,
                                  init_ids=ids, device="cpu")
    assert got_l.dtype == np.int32 and got_c.dtype == np.float32
    assert np.array_equal(got_l, want_l)
    assert np.array_equal(got_c, want_c)


def test_kmeans_subsample_follows_jax_draws(monkeypatch):
    """Above SEED_SAMPLE points the seeding sample is rng.choice's, in
    JAX's order (the limit lowered to 500 in both packages)."""
    monkeypatch.setattr(cluster, "SEED_SAMPLE", 500)
    seen = {}
    real = cluster._kmeanspp_init

    def spy(sample, K, **kw):
        seen["sample"] = sample.clone()
        return real(sample, K, **kw)

    monkeypatch.setattr(cluster, "_kmeanspp_init", spy)
    v = _int_clusters(np.random.default_rng(4))
    cluster.kmeans(v, 8, n_iter=1, seed=5, device="cpu")
    want = v[np.random.default_rng(5).choice(len(v), 500, replace=False)]
    assert np.array_equal(seen["sample"].numpy(), want)


def test_cluster_searcher_matches_jax_given_its_seeding():
    rng = np.random.default_rng(5)
    v = _int_clusters(rng)
    q = v[rng.choice(len(v), 70, replace=False)] \
        + rng.integers(-1, 2, (70, v.shape[1]))
    ids = _jax_seed_ids(v, 2, 16)
    want = jcluster.ClusterSearcher(v, 16, n_iter=6, seed=2)
    got = cluster.ClusterSearcher(v, 16, n_iter=6, seed=2, init_ids=ids,
                                  device="cpu")
    assert np.array_equal(got.labels, want.labels)
    assert np.array_equal(got.centroids, want.centroids)
    r_got, r_want = got.search(q, 10), want.search(q, 10)
    assert r_got.dtype == np.int64
    assert np.array_equal(r_got, r_want)
    # a k past the smallest cluster's size pads with -1, as JAX's does
    assert np.array_equal(got.search(q[:5], 100), want.search(q[:5], 100))


def test_kmeans_launches_one_distance_a_center_block_and_query_block(
        monkeypatch):
    """The l2_distance calls that K6 serves on the card: one a seeding
    center, one a Lloyd block an iteration, one a query block."""
    calls = []
    real = distance.l2_distance

    def counted(q, p, *a, **kw):
        calls.append((tuple(q.shape), tuple(p.shape)))
        return real(q, p, *a, **kw)

    monkeypatch.setattr(cluster, "l2_distance", counted)
    v = _int_clusters(np.random.default_rng(6))
    s = cluster.ClusterSearcher(v, 16, n_iter=3, seed=0, device="cpu")
    assert len(calls) == 16 + 3 * 1
    s.search(v[:130], 5)
    assert len(calls) == 16 + 3 + 3


def test_kmeans_recovers_clusters():
    """Twin of tests/test_cluster.py's, with the port's own seeding."""
    rng = np.random.default_rng(0)
    vectors, centers = _clustered_data(rng)
    cents, labels = cluster.kmeans(vectors, 16, n_iter=15, seed=1,
                                   device="cpu")
    true = np.repeat(np.arange(16), 128)
    agree = 0
    for c in range(16):
        lab = labels[true == c]
        agree += np.max(np.bincount(lab, minlength=16))
    assert agree / len(labels) > 0.95


def test_cluster_search_recall_on_clustered_data():
    """Twin of tests/test_cluster.py's, with the port's own seeding."""
    rng = np.random.default_rng(1)
    vectors, _ = _clustered_data(rng)
    queries = vectors[rng.choice(len(vectors), 32, replace=False)] \
        + rng.standard_normal((32, vectors.shape[1])).astype(np.float32) * 0.05
    searcher = cluster.ClusterSearcher(vectors, 16, n_iter=15, seed=2,
                                       device="cpu")
    ids = searcher.search(queries, 10)
    gnd = brute_force_knn(vectors, queries, 10, device="cpu")
    recall = compute_recall(gnd, ids, 10)
    assert recall > 0.9, recall


def _printed(capsys, what):
    out = capsys.readouterr().out
    return re.search(rf"{what}: ([0-9.]+)", out).group(1)


def test_cli_matches_jax_printed_recall(tmp_path, capsys, monkeypatch):
    """cli/cluster_search.py on .npy inputs and JAX's, the port seeded with
    JAX's ids, one ground-truth file (equal distances abound here, and the
    two brute_force_knn break ties differently): the same printed recall
    and report lines; without the seeding ids the port's own draws give a
    recall within 0.1 of it."""
    rng = np.random.default_rng(7)
    v = _int_clusters(rng, n_clusters=25, per=40)
    q = (v[rng.choice(len(v), 30, replace=False)] + 1).astype(np.float32)
    np.save(tmp_path / "v.npy", v)
    np.save(tmp_path / "q.npy", q)
    np.save(tmp_path / "gnd.npy", brute_force_knn(v, q, 10, device="cpu"))
    argv = ["-n", str(len(v)), "-d", "8", "-q", "30", "-k", "10",
            "-input", str(tmp_path / "v.npy"), "-query",
            str(tmp_path / "q.npy"), "-iters", "5", "-seed", "3",
            "-clusters", "25", "-gnd", str(tmp_path / "gnd.npy")]
    assert jcli.main(argv + ["-report", str(tmp_path / "j.txt")]) == 0
    want = _printed(capsys, "Recall@10")
    ids = _jax_seed_ids(v, 3, 25)
    real = cluster.kmeans
    monkeypatch.setattr(cluster, "kmeans", lambda *a, **kw: real(
        *a, **{**kw, "init_ids": ids}))
    assert cluster_search.main(argv + ["-report", str(tmp_path / "p.txt")],
                               device="cpu") == 0
    assert _printed(capsys, "Recall@10") == want
    lines = [(tmp_path / f).read_text().splitlines() for f in ("j.txt",
                                                               "p.txt")]
    assert lines[0][1] == lines[1][1] and lines[1][0].startswith(
        "avg query time (ms): ")
    monkeypatch.setattr(cluster, "kmeans", real)
    assert cluster_search.main(argv, device="cpu") == 0
    assert abs(float(_printed(capsys, "Recall@10")) - float(want)) <= 0.1


def test_cluster_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    v = np.zeros((64, 4), np.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cluster.kmeans(v, 4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cluster.ClusterSearcher(v, 4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cluster_search.main(["-n", "64", "-q", "2", "-d", "4"])
    # a CPU tensor stays on the CPU
    assert cluster.ClusterSearcher(torch.from_numpy(
        _int_clusters(np.random.default_rng(8))), 4, n_iter=1).device.type \
        == "cpu"
