"""Graph construction, the port of the JAX package's graph/build.py: so far
only `choose_start_ids`, the k-means start vertices that the private
driver's `start_mode="centroid"` reaches, with its helpers.

The rest of build.py (the k-means bootstrap, NN-descent, corridor
candidates, the Kleinberg ladder, the robust prune, degree regularization,
random fill and the quality gate: `build_graph`) is ROADMAP Queue 1's item
"The graph build". Until it lands, the callers that would build a graph
raise `graph_build_not_ported(...)`.
"""

from __future__ import annotations

import numpy as np
import torch

from pacmann_tpu_torch.utils import cuda_lib

# What the callers that need build_graph raise until it is ported.
GRAPH_BUILD_ITEM = 'ROADMAP Queue 1, "The graph build"'


def graph_build_not_ported(what: str) -> NotImplementedError:
    """The error of a caller that needs build_graph: `what` names the call."""
    return NotImplementedError(
        f"{what} needs the graph build (graph/build.py::build_graph), which "
        f"is not ported yet: {GRAPH_BUILD_ITEM}")


# narrow host dtypes uploaded as they are and widened to f32 on the device
# (u8 -> f32 is exact)
_COMPACT_DTYPES = ("uint8", "int8", "float16")


def _compact_host(vectors) -> np.ndarray:
    """Normalize a host vector matrix for upload: narrow dtypes are kept
    (widened to f32 on the device after transfer); everything else becomes
    float32 on the host."""
    vectors = np.asarray(vectors)
    if vectors.dtype.name in _COMPACT_DTYPES:
        return np.ascontiguousarray(vectors)
    return np.asarray(vectors, np.float32)


def _lloyd_sums(vectors: torch.Tensor, labels: torch.Tensor, *, K: int,
                block: int):
    """Per-cell vector sums and counts, by blocked one-hot matmuls."""
    d = vectors.shape[1]
    dev = vectors.device
    sums = torch.zeros((K, d), dtype=torch.float32, device=dev)
    cnts = torch.zeros((K,), dtype=torch.float32, device=dev)
    cells = torch.arange(K, device=dev)
    for b0 in range(0, vectors.shape[0], block):
        oh = (labels[b0:b0 + block, None] == cells[None, :]).float()
        sums += oh.T @ vectors[b0:b0 + block]
        cnts += oh.sum(dim=0)
    return sums, cnts


def _lloyd_iter(vectors: torch.Tensor, cent: torch.Tensor, *,
                block: int) -> torch.Tensor:
    """One Lloyd iteration: assign each vector to its nearest centroid
    (argmin of |c|^2 - 2 v.c, the first on ties), then move each centroid
    with members to their mean."""
    cn = (cent * cent).sum(dim=1)
    labels = torch.cat([
        torch.argmin(cn[None, :] - 2.0 * (vectors[b0:b0 + block] @ cent.T),
                     dim=1)
        for b0 in range(0, vectors.shape[0], block)])
    sums, cnts = _lloyd_sums(vectors, labels, K=cent.shape[0], block=block)
    return torch.where(cnts[:, None] > 0,
                       sums / torch.clamp(cnts, min=1.0)[:, None], cent)


def _nearest_vertex_device(vectors: torch.Tensor, cent: torch.Tensor, *,
                           block: int) -> torch.Tensor:
    """Nearest vertex id per centroid: a blocked running argmin (an earlier
    block keeps a tie)."""
    K = cent.shape[0]
    dev = vectors.device
    best_d = torch.full((K,), float("inf"), device=dev)
    best_i = torch.zeros((K,), dtype=torch.int64, device=dev)
    for b0 in range(0, vectors.shape[0], block):
        q = vectors[b0:b0 + block]
        # the centroid-norm term is constant per column: argmin-invariant
        dist = (q * q).sum(dim=1)[:, None] - 2.0 * (q @ cent.T)  # (block, K)
        bd, bi = torch.min(dist, dim=0)
        take = bd < best_d
        best_d = torch.where(take, bd, best_d)
        best_i = torch.where(take, bi + b0, best_i)
    return best_i


def choose_start_ids(vectors, n_starts: int, *, iters: int = 3,
                     seed: int = 0, block: int = 4096, init_ids=None,
                     device=None) -> np.ndarray:
    """Coverage-optimized beam-search start vertices: the nearest vertex of
    each of n_starts k-means centroids (a few Lloyd passes of matmuls on
    `device`), duplicates topped up with random distinct ids.

    The reference starts every search from the first sqrt(n) vertex ids
    (search.go:51-65); centroid starts cut the beam's descent depth. The
    start set is part of the index, not the query protocol: same count, same
    per-query cost, no privacy change.

    init_ids: the (n_starts,) ids of the initial centroids. The JAX package
    draws them with jax.random.randint(PRNGKey(seed), ...), which torch
    cannot reproduce; when not given they are drawn from a torch.Generator
    seeded with `seed`. The top-up draws from np.random.default_rng(seed),
    as the JAX package's does. vectors: (n, d) numpy array or tensor;
    device None means a tensor's own device, else the card."""
    dev = cuda_lib.default_device(vectors, device)
    n = vectors.shape[0]
    n_starts = min(n_starts, n)
    blk = min(block, n)
    if isinstance(vectors, torch.Tensor):
        v = vectors.to(dev).float()
    else:
        v = torch.from_numpy(_compact_host(vectors)).to(dev).float()
    if init_ids is None:
        gen = torch.Generator().manual_seed(seed)
        init_ids = torch.randint(0, n, (n_starts,), generator=gen)
    cent = v[torch.as_tensor(np.array(init_ids, np.int64), device=dev)]
    for _ in range(iters):
        cent = _lloyd_iter(v, cent, block=blk)
    ids = _nearest_vertex_device(v, cent, block=blk).cpu().numpy()
    # several centroids can resolve to one vertex; duplicate starts waste
    # seed slots (the reference draws distinct random ids,
    # private-search.go:505-528): top up with random distinct ids
    uniq = np.unique(ids)
    if uniq.size < n_starts:
        rng = np.random.default_rng(seed)
        pool = rng.permutation(n)
        extra = pool[~np.isin(pool, uniq, assume_unique=False)]
        ids = np.concatenate([uniq, extra[: n_starts - uniq.size]])
    return ids.astype(np.int64)
