"""The benchmark's plain references for the exact and plaintext cells
(benchmark/reference/plain.py, benchmark/reference/graph.py::ground_truth)
against the port's own paths on the CPU, on u8-valued data where every
fp32 distance is exact: the reference beam equals PlaintextEngine.search
id for id, on a graph whose frontiers run empty (padding ids fetched,
all-zero neighbour rows skipped) and on one whose frontiers never do; the
float64 brute force equals knn_search on data with planted ties."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pacmann_tpu_torch.graph import beam
from pacmann_tpu_torch.graph.recall import knn_search

sys.path.append(str(Path(__file__).resolve().parent.parent / "benchmark"))

from reference.graph import ground_truth  # noqa: E402
from reference.plain import beam_search  # noqa: E402

N, D, M, Q = 4096, 128, 32, 64
K, STEPS, PAR = 10, 20, 3


def _graph(kind: str) -> np.ndarray:
    rng = np.random.default_rng(8)
    if kind == "uniform":
        return rng.integers(0, N, size=(N, M)).astype(np.int32)
    # each vertex's neighbours drawn from its own cluster of 8 ids, and every
    # 7th vertex's row all zero: a few pops reach a whole cluster, and a
    # frontier runs empty until a padding id lands in another
    own = np.arange(N)[:, None] // 8 * 8
    g = (own + rng.integers(0, 8, size=(N, M))).astype(np.int32)
    g[::7] = 0
    return g


@pytest.mark.parametrize("kind", ("uniform", "clusters"))
def test_reference_beam_equals_the_plaintext_engine(kind):
    rng = np.random.default_rng(3)
    vectors = torch.from_numpy(
        rng.integers(0, 256, size=(N, D)).astype(np.float32))
    queries = torch.from_numpy(
        rng.integers(0, 256, size=(Q, D)).astype(np.float32))
    graph = _graph(kind)
    gen = torch.Generator().manual_seed(11)
    rand = torch.randint(0, N, (Q, STEPS, PAR, M), generator=gen,
                         dtype=torch.int32)
    eng = beam.PlaintextEngine(vectors, graph, device="cpu")
    got, _ = eng.search(queries, K, STEPS, PAR, step_randoms=rand)
    want = beam_search(vectors, torch.from_numpy(graph), eng.start_ids,
                       queries, rand, k=K, steps=STEPS, parallel=PAR)
    assert np.array_equal(got, want.numpy())
    assert (got >= 0).all()
    # the case holds what its name says: pops that found no frontier
    _, popped = beam._beam_search(
        eng.vectors, eng.graph, eng.start_ids, queries, rand, n=N, m=M,
        max_step=STEPS, parallel=PAR)
    assert bool((popped < 0).any()) == (kind == "clusters")


def test_ground_truth_equals_knn_search_with_planted_ties():
    """Components in [0, 4) and whole rows repeated: many equal distances,
    within and across knn_search's point blocks; both take the lower id."""
    rng = np.random.default_rng(5)
    v = rng.integers(0, 4, size=(5000, 16))
    v[2500:3000] = v[:500]
    q = np.concatenate([rng.integers(0, 4, size=(40, 16)), v[[7, 2507]]])
    vt, qt = (torch.from_numpy(x.astype(np.float32)) for x in (v, q))
    got = knn_search(vt, qt, 10, p_block=1024)[1]
    assert torch.equal(got, ground_truth(vt, qt, 10))
    # a repeated row's twin ranks right after it
    assert got[-2, :2].tolist() == [7, 2507]
