"""The port's loaders, recall, exact k-NN and command-line entry points (io/,
graph/recall.py, cli/) against the JAX package's, on the checked-in mini
SIFT-format fixtures and small synthetic data, all on the CPU."""

import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from pacmann_tpu.cli import ann as jann
from pacmann_tpu.cli import exact_search as jexact
from pacmann_tpu.graph import recall as jrecall
from pacmann_tpu.io import loaders as jloaders
from pacmann_tpu.ops.distance import l2_distance_xla
from pacmann_tpu_torch.cli import ann, cluster_search, exact_search
from pacmann_tpu_torch.graph import beam, build, cluster, recall
from pacmann_tpu_torch.io import loaders
from pacmann_tpu_torch.ops import distance
from pacmann_tpu_torch.utils.u32 import smallest_k, smallest_k_keyed

torch.set_num_threads(1)

FIX = os.path.join(os.path.dirname(__file__), "fixtures")
N, DIM, Q, K = 256, 128, 8, 10
FILES = {"base": ("mini_base.bvecs", N, DIM),
         "query": ("mini_query.fvecs", Q, DIM),
         "gnd": ("mini_gnd.ivecs", Q, K)}


def _fix(name):
    return os.path.join(FIX, FILES[name][0])


@pytest.mark.parametrize("name", sorted(FILES))
def test_loaders_match_jax_on_fixtures(name):
    path, n, dim = os.path.join(FIX, FILES[name][0]), *FILES[name][1:]
    load = loaders.load_int_matrix if name == "gnd" \
        else loaders.load_float32_matrix
    jload = jloaders.load_int_matrix if name == "gnd" \
        else jloaders.load_float32_matrix
    got, want = load(path, n, dim), jload(path, n, dim)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    if name == "base":
        raw = loaders.load_bvecs(path, n, dim, keep_bytes=True)
        assert raw.dtype == np.uint8 and np.array_equal(raw, want)
        assert want[0, 3] == 1.0 and want[1, 0] == 65.0


@pytest.mark.parametrize("ext", [".npy", ".txt"])
def test_save_load_roundtrip_with_jax(tmp_path, ext):
    graph = np.random.default_rng(3).integers(0, 1000, (50, 8))
    p = str(tmp_path / ("g" + ext))
    loaders.save_int_matrix(p, graph)
    assert np.array_equal(jloaders.load_int_matrix(p, 50, 8), graph)
    assert np.array_equal(loaders.load_int_matrix(p, 50, 8), graph)


def test_compute_recall_matches_jax():
    rng = np.random.default_rng(0)
    gnd = rng.integers(0, 40, (20, 12))
    resp = rng.integers(0, 40, (20, 12))      # duplicates within rows too
    for k in (1, 5, 10):
        assert recall.compute_recall(gnd, resp, k) \
            == jrecall.compute_recall(gnd, resp, k)


def test_smallest_k_keyed_matches_stable_sort():
    """Many equal values: the keyed top-k gives smallest_k's ids."""
    x = torch.from_numpy(np.random.default_rng(1).integers(
        0, 6, (7, 300)).astype(np.float32))
    ids = torch.arange(300)
    for k in (1, 10, 300):
        v1, i1 = smallest_k(x, k)
        v2, i2 = smallest_k_keyed(x, ids, k)
        assert torch.equal(v1, v2) and torch.equal(i1, i2)


def test_knn_search_matches_lax_top_k_with_ties():
    """Integer data with many ties, blocked over queries (more than one
    block of 1,024) and points: the ids of lax.top_k over whole rows (equal
    distances by the lower id)."""
    rng = np.random.default_rng(2)
    v = rng.integers(0, 3, (500, 12)).astype(np.float32)
    q = rng.integers(0, 3, (1100, 12)).astype(np.float32)
    neg, want = jax.lax.top_k(-l2_distance_xla(q, v), 15)
    d, ids = recall.knn_search(torch.from_numpy(v), torch.from_numpy(q), 15,
                               p_block=64)
    assert np.array_equal(ids.numpy(), np.asarray(want))
    assert np.array_equal(d.numpy(), -np.asarray(neg))


def test_brute_force_knn_matches_jax():
    """Float data (no ties): the same ids. Integer data with ties: JAX's
    argpartition is not tie-stable, so the distances match as multisets."""
    rng = np.random.default_rng(4)
    v = rng.random((700, 16), dtype=np.float32)
    q = rng.random((30, 16), dtype=np.float32)
    got = recall.brute_force_knn(v, q, 10, block=128, device="cpu")
    assert got.dtype == np.int64
    assert np.array_equal(got, jrecall.brute_force_knn(v, q, 10, block=128))
    vi = rng.integers(0, 4, (700, 8)).astype(np.float32)
    qi = rng.integers(0, 4, (30, 8)).astype(np.float32)
    got = recall.brute_force_knn(vi, qi, 10, block=128, device="cpu")
    want = jrecall.brute_force_knn(vi, qi, 10, block=128)
    d = np.asarray(l2_distance_xla(qi, vi))
    rows = np.arange(30)[:, None]
    assert np.array_equal(np.sort(d[rows, got], 1), np.sort(d[rows, want], 1))


@pytest.fixture(scope="module")
def mini(tmp_path_factory):
    """The fixtures' base vectors and their exact 8-NN graph (self
    dropped), saved as a graph file."""
    base = jloaders.load_bvecs(_fix("base"), N, DIM)
    d = ((base[:, None, :] - base[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d, np.inf)
    graph = np.argsort(d, axis=1, kind="stable")[:, :8]
    path = str(tmp_path_factory.mktemp("g") / "mini_graph.npy")
    jloaders.save_int_matrix(path, graph)
    return base, graph, path


@pytest.mark.parametrize("use_engine", [True, False])
def test_evaluate_graph_quality_matches_jax(mini, use_engine):
    base, graph, _ = mini
    got = recall.evaluate_graph_quality(base, graph, num_queries=40, seed=3,
                                        use_engine=use_engine, device="cpu")
    want = jrecall.evaluate_graph_quality(base, graph, num_queries=40,
                                          seed=3, use_engine=use_engine)
    assert got == want


def _printed(capsys, what):
    out = capsys.readouterr().out
    return re.search(rf"{what}: ([0-9.]+)", out).group(1)


def test_ann_main_matches_jax(mini, capsys, tmp_path):
    _, _, graph_path = mini
    argv = ["-n", str(N), "-d", str(DIM), "-m", "8", "-k", str(K), "-q",
            str(Q), "-input", _fix("base"), "-query", _fix("query"),
            "-graph", graph_path, "-step", "8", "-parallel", "2"]
    out_path = str(tmp_path / "ids.npy")
    assert ann.main(argv + ["-gnd", _fix("gnd"), "-output", out_path],
                    device="cpu") == 0
    got = _printed(capsys, "Recall@10")
    assert np.load(out_path).shape == (Q, K)
    assert jann.main(argv + ["-gnd", _fix("gnd")]) == 0
    assert got == _printed(capsys, "Recall@10")
    # without -gnd the ground truth is the port's brute_force_knn
    assert ann.main(argv, device="cpu") == 0
    assert _printed(capsys, "Recall@10") == got


def test_exact_search_main_matches_jax(capsys):
    argv = ["-n", str(N), "-d", str(DIM), "-k", str(K), "-q", str(Q),
            "-input", _fix("base"), "-query", _fix("query"),
            "-gnd", _fix("gnd")]
    assert exact_search.main(argv, device="cpu") == 0
    got = _printed(capsys, "Recall@10")
    assert jexact.main(argv) == 0
    assert got == _printed(capsys, "Recall@10") == "1.0000"


def test_unported_paths_raise(mini, capsys, tmp_path):
    """The calls that raised until their modules were ported now run:
    -shards > 1 (until the multi-device tier; it runs over a mesh of that
    many shards of `device`), ann without a graph file and with a missing
    one (built, then saved there), and the gate's search_fn hook."""
    base, graph, _ = mini
    assert exact_search.main(["-n", "64", "-q", "2", "-shards", "2"],
                             device="cpu") == 0
    assert "over 2 shards on 1 device(s)" in capsys.readouterr().out
    assert ann.main(["-n", "64", "-q", "2", "-m", "4"], device="cpu") == 0
    assert "Graph build time: " in capsys.readouterr().out
    path = tmp_path / "built.npy"
    assert ann.main(["-n", "64", "-q", "2", "-m", "4", "-graph", str(path)],
                    device="cpu") == 0
    assert jloaders.load_int_matrix(str(path), 64, 4).shape == (64, 4)
    seen = []

    def search_fn(v, g, starts, q, seed):
        seen.append((v.dtype, g.dtype, starts.tolist(), q.shape, seed))
        return beam.PlaintextEngine(v, g, start_ids=starts).search(
            q, 20, 20, 2, seed=seed)

    got = recall.evaluate_graph_quality(base, graph, num_queries=40, seed=3,
                                        search_fn=search_fn, device="cpu")
    assert seen == [(torch.float32, torch.int32, list(range(16)), (40, DIM),
                     3)]
    assert got == recall.evaluate_graph_quality(base, graph, num_queries=40,
                                                seed=3, device="cpu")


def test_ann_main_builds_like_jax(mini, capsys):
    """ann without -graph on the mini fixtures: both packages build (each
    from its own draws) and print a build time; the port's recall@10 on
    the 8 queries is at least JAX's printed one less 0.05 (their graphs
    differ, so an id or two of the 80 may)."""
    argv = ["-n", str(N), "-d", str(DIM), "-m", "8", "-k", str(K), "-q",
            str(Q), "-input", _fix("base"), "-query", _fix("query"),
            "-gnd", _fix("gnd"), "-step", "8", "-parallel", "2"]
    assert ann.main(argv, device="cpu") == 0
    out = capsys.readouterr().out
    assert "Graph build time: " in out
    got = float(re.search(r"Recall@10: ([0-9.]+)", out).group(1))
    assert jann.main(argv) == 0
    want = float(_printed(capsys, "Recall@10"))
    assert got >= want - 0.05, (got, want)


def test_entry_points_default_to_cuda(monkeypatch):
    """Without device="cpu" the entry points, brute_force_knn and the
    distances ask for CUDA for numpy input and raise where it is missing; a
    CPU tensor stays on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        exact_search.main(["-n", "64", "-q", "2"])
    # the graph build and the cluster baseline, and both CLIs that run them
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ann.main(["-n", "64", "-q", "2", "-m", "4"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cluster_search.main(["-n", "64", "-q", "2"])
    v64 = np.random.default_rng(0).random((64, 4), dtype=np.float32)
    for fn in (lambda x: build.build_graph(x, 4, rounds=1),
               lambda x: cluster.kmeans(x, 4, n_iter=1),
               lambda x: cluster.ClusterSearcher(x, 4, n_iter=1)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn(v64)
        fn(torch.from_numpy(v64))        # a CPU tensor stays on the CPU
    v = np.zeros((8, 4), np.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        recall.brute_force_knn(v, v, 2)
    assert recall.brute_force_knn(torch.from_numpy(v), v, 2).shape == (8, 2)
    for fn in (distance.l2_distance, distance.l2_distance_plain,
               distance.inner_product, distance.l2_distance_single):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn(v.astype(np.int32), v.astype(np.int32))
        got = fn(torch.from_numpy(v).to(torch.int32), v.astype(np.int32))
        assert got.device.type == "cpu"
        assert fn(v.astype(np.int32), v, device="cpu").device.type == "cpu"


def test_port_imports_no_jax_in_new_modules():
    code = ("import sys, pacmann_tpu_torch.graph, pacmann_tpu_torch.io, "
            "pacmann_tpu_torch.cli.ann, pacmann_tpu_torch.cli.exact_search, "
            "pacmann_tpu_torch.ops.distance, pacmann_tpu_torch.graph.build, "
            "pacmann_tpu_torch.graph.cluster, "
            "pacmann_tpu_torch.cli.cluster_search, "
            "pacmann_tpu_torch.private.driver; "
            "assert 'jax' not in sys.modules, 'jax imported'")
    subprocess.run([sys.executable, "-c", code], check=True)
