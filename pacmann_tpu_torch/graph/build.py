"""Vamana-style constant-degree graph construction, the port of the JAX
package's graph/build.py.

The reference's candidate generation and scalar robustPrune
(graphann/build_graph.go:96-511) as batched torch passes on the vectors'
device:

  1. a k-means bootstrap: a few Lloyd iterations cut the space into ~K
     cells, and each vertex starts with m random members of its own cell;
  2. NN-descent rounds: each vertex scores its neighbours, sampled
     neighbours-of-neighbours, sampled reverse edges and their neighbours
     and a few random vertices, keeping the closest m; then a wide round
     keeps the closest 1.5m + m - m/2 of all m^2 neighbours-of-neighbours;
  3. long-range candidates: far random vertices and a Kleinberg ladder
     (one member of the cell ranked 2^j by centroid distance);
  4. a navigable graph by robust alpha-prune (DiskANN, alpha = 1.2, the
     nearest `keep_nearest` kept) of locals, ladder and far randoms; the
     expansion corridor of a beam search for every vertex's own vector over
     it (graph/beam.py::search_paths_all); the final prune of all four;
  5. degree regularization (build_graph.go:414-484): bidirectionalize, keep
     edge x->y with probability min(1.5m / inbound[y], 1), re-prune lists
     above m, random fill to exactly m; the quality gate.

Everything the JAX package computes there is XLA ops, no Pallas kernel, so
every stage is plain torch; the matrix products run in full fp32 (TF32 off
on CUDA). On integer-valued vectors every f32 distance is exact and each
stage equals the JAX package's bit for bit given the same draws.

Randomness: torch cannot reproduce jax.random. Every draw of the build is a
named draw (BuildDraws), keyed by vertex row, never by a compute block, so
the port's chunking never changes a result. A caller may hand any draw in
(the tests hand in JAX's, rebuilt per block and concatenated in row
order); the others are counter-based hashes of (seed, name, element)
computed on the build's device, so a seed gives the same draws on every
device. The numpy draws (the corridor start ids, the host fill) keep
JAX's order on one np.random.default_rng(seed).

Left out, being TPU mechanism: the AOT precompile threads and their
call-time fallback, the sliced wide round of big builds (one program per
slice, a v5e fault workaround: the single wide round runs for every n),
the corridor block scaling (another fault workaround) and the HBM
telemetry (the verbose lines print torch.cuda.max_memory_allocated).

Also here: `choose_start_ids`, the k-means start vertices that the private
driver's `start_mode="centroid"` reaches.
"""

from __future__ import annotations

import time
import zlib

import numpy as np
import torch

from pacmann_tpu_torch.utils import cuda_lib
from pacmann_tpu_torch.utils.u32 import smallest_k

ALPHA = 1.2  # build_graph.go:357
INF = float("inf")
# rounds of the device random fill (_random_fill_device)
FILL_ROUNDS = 8
# scratch bytes one pass holds at once on each device type: a pass takes
# as many rows at a time as fit (results never depend on it)
CHUNK_BYTES = {"cuda": 4 << 30, "cpu": 256 << 20}

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


def _chunks(n: int, row_bytes: int, device: torch.device):
    """(r0, r1) row ranges covering [0, n), each holding at most the
    device's CHUNK_BYTES of row_bytes-byte rows (at least one row)."""
    rows = max(1, min(n, CHUNK_BYTES[device.type] // max(row_bytes, 1)))
    return [(r0, min(r0 + rows, n)) for r0 in range(0, n, rows)]


_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32): two 16-bit halves of c,
    so no product leaves int64."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _hash32(x: torch.Tensor) -> torch.Tensor:
    """lowbias32, a bijection of [0, 2^32), on int64 tensors."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


class BuildDraws:
    """The graph build's random draws, by name.

    `given` maps a draw's name to the array the caller hands in (ids, bits
    as values in [0, 2^32), or floats). Every other draw is counter-based:
    element i of draw `name` is a hash of (seed, name, i), computed on the
    device that uses it, so a seed gives the same draws on every device
    and however a pass chunks its rows. keep: remember every draw made
    (`made()`), to hand the same values to another build. `seconds` sums
    the time spent drawing."""

    def __init__(self, seed: int, given: dict | None = None, *,
                 keep: bool = False):
        self.seed = seed
        self.given = dict(given or {})
        self.seconds = 0.0
        self._kept = {} if keep else None

    def _keys(self, name: str) -> tuple[int, int]:
        lo, hi = self.seed & _M32, (self.seed >> 32) & _M32
        return (zlib.crc32(name.encode(), lo),
                zlib.crc32(b"\x01" + name.encode(), hi ^ 0x9E3779B9))

    def _hash(self, name: str, shape, device, offset: int = 0):
        """u32 values as int64, element i of the draw at offset + i."""
        k0, k1 = self._keys(name)
        numel = int(np.prod(shape, dtype=np.int64))
        i = torch.arange(offset, offset + numel, dtype=torch.int64,
                         device=device)
        h = _hash32((i & _M32) ^ k0)
        return _hash32(h ^ (i >> 32) ^ k1).reshape(tuple(shape))

    @staticmethod
    def _clock(device: torch.device) -> float:
        """The host's clock once the device's queued work is done (so a
        draw's time holds its own kernels, not earlier work)."""
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter()

    def _take(self, name, shape, dtype, device, make):
        if name in self.given:
            t = torch.as_tensor(np.asarray(self.given[name])).to(dtype)
            if tuple(t.shape) != tuple(shape):
                raise ValueError(f"draw {name}: shape {tuple(t.shape)}, "
                                 f"expected {tuple(shape)}")
            return t.to(device)
        device = torch.device(device)
        t0 = self._clock(device)
        out = make(self._hash(name, shape, device)).to(dtype)
        self.seconds += self._clock(device) - t0
        if self._kept is not None:
            self._kept[name] = out.cpu()
        return out

    def ints(self, name: str, shape, high: int, device) -> torch.Tensor:
        """Uniform ids in [0, high), int64 (jax.random.randint): the top
        bits of h * high."""
        if high > 1 << 31:
            raise ValueError(f"draw {name}: high {high} above 2^31")
        return self._take(name, shape, torch.int64, device,
                          lambda h: (h * high) >> 32)

    def bits(self, name: str, shape, device) -> torch.Tensor:
        """Uniform u32 values as int64 in [0, 2^32) (jax.random.bits)."""
        return self._take(name, shape, torch.int64, device, lambda h: h)

    def uniform(self, name: str, shape, device) -> torch.Tensor:
        """Uniform f32 in [0, 1) (jax.random.uniform): the top 24 bits."""
        return self._take(name, shape, torch.float32, device,
                          lambda h: (h >> 8).float() * 2.0 ** -24)

    def step_randoms(self, name: str, npad: int, shape, high: int, device):
        """A search_paths_all step_randoms callable: rows [r0, r1) of the
        (npad, *shape) draw of ids in [0, high), int32, made on `device`
        block by block."""
        if name in self.given:
            whole = torch.as_tensor(np.asarray(self.given[name]))
            if tuple(whole.shape) != (npad, *shape):
                raise ValueError(f"draw {name}: shape {tuple(whole.shape)}")
            return lambda r0, r1: whole[r0:r1]
        row = int(np.prod(shape, dtype=np.int64))
        device = torch.device(device)

        def rows(r0, r1):
            t0 = self._clock(device)
            h = self._hash(name, (r1 - r0, *shape), device, offset=r0 * row)
            out = ((h * high) >> 32).to(torch.int32)
            self.seconds += self._clock(device) - t0
            if self._kept is not None:
                self._kept.setdefault(name, {})[r0] = out.cpu()
            return out
        return rows

    def made(self) -> dict:
        """Every draw made so far (keep=True), by name, as CPU tensors:
        build_graph(draws=...) takes them back."""
        return {k: torch.cat([v[r] for r in sorted(v)])
                if isinstance(v, dict) else v
                for k, v in self._kept.items()}


# ---------------------------------------------------------------------------
# batched candidate scoring


def _select_topk_sorted(vectors, sqn, q, self_ids, cand, out_m: int):
    """Top-out_m distinct candidates by L2 (no self), sort-based dedup.

    cand (B, C) ids; returns ((B, out_m) ids, (B, out_m) dists), ascending,
    equal distances by the lower column of the id-sorted pool (lax.top_k's
    order). Distances in the dot identity's order, (|c|^2 - 2 q.c) +
    |q|^2; a repeated id and self get +inf."""
    cv = vectors[cand]                                    # (B, C, d)
    dots = torch.bmm(cv, q[:, :, None])[:, :, 0]
    del cv
    dist = sqn[cand] - 2.0 * dots + (q * q).sum(dim=1, keepdim=True)
    cs, order = torch.sort(cand, dim=1, stable=True)
    ds = torch.gather(dist, 1, order)
    dup = torch.zeros_like(cs, dtype=torch.bool)
    dup[:, 1:] = cs[:, 1:] == cs[:, :-1]
    ds = torch.where(dup | (cs == self_ids[:, None]), INF, ds)
    d, idx = smallest_k(ds, out_m)
    return torch.gather(cs, 1, idx), d


def _sort_keyed(primary: torch.Tensor, tie: torch.Tensor) -> torch.Tensor:
    """The stable order of (primary, tie) pairs, primary in [0, 2^31) and
    tie an unsigned value in [0, 2^32): lax.sort on two keys, as one int64
    key primary << 32 | tie sorted stably."""
    return torch.sort((primary << 32) | tie, stable=True).indices


def _reverse_sample_device(graph, tie, fill, nsn: int, n_real: int):
    """(npad, nsn) ids: for each directed edge u->v, v receives up to nsn
    random u's (the order of their tie bits), empty slots filled with
    random real ids. tie: (npad * m,) u32 values, one an edge in row order;
    fill: (npad, nsn) ids in [0, n_real)."""
    npad, m = graph.shape
    E = npad * m
    dev = graph.device
    dst = graph.reshape(-1).long()
    src = torch.arange(E, device=dev) // m
    order = _sort_keyed(dst, tie)
    dst_s, src_s = dst[order], src[order]
    starts = torch.searchsorted(dst_s, torch.arange(npad, device=dev))
    rank = torch.arange(E, device=dev) - starts[dst_s]
    keep = rank < nsn                                     # nsn on: dropped
    rev = torch.full((npad, nsn), -1, dtype=torch.int64, device=dev)
    rev[dst_s[keep], rank[keep]] = src_s[keep]
    # padded vertices (id >= n_real) may appear as sources: replaced too
    return torch.where((rev < 0) | (rev >= n_real), fill, rev)


def _nn_round_device(vectors, sqn, graph, rand: dict, *, nsn: int,
                     n_random: int, n_real: int, out_m: int, wide: bool):
    """One full NN-descent round -> ((npad, out_m) ids, dists).

    wide=False: candidates = own neighbours + nsn sampled neighbours-of-
    neighbours each + nsn reverse edges + 2 nsn sampled neighbours of each
    reverse edge + n_random randoms, keep the top out_m = m. wide=True: the
    final widened pool, all m^2 neighbours-of-neighbours + randoms, keep
    the top out_m (the prune pool; build_graph.go:384's role).

    rand: the round's draws, row i for vertex i: "rnd" (npad, n_random)
    ids in [0, n_real); without wide also "tie" (npad * m,) u32 values and
    "fill" (npad, nsn) ids (the reverse sample), "pick" (npad, m, nsn) and
    "rpick" (npad, nsn, 2 nsn) columns in [0, m)."""
    npad, m = graph.shape
    d = vectors.shape[1]
    dev = vectors.device
    rev = None if wide else _reverse_sample_device(
        graph, rand["tie"], rand["fill"], nsn, n_real)
    width = m + m * m + n_random if wide \
        else m + m * nsn + nsn + 2 * nsn * nsn + n_random
    ids_out, d_out = [], []
    for r0, r1 in _chunks(npad, width * (d * 4 + 40), dev):
        B = r1 - r0
        nbrs = graph[r0:r1]
        nn_all = graph[nbrs.reshape(-1)].reshape(B, m, m)
        if wide:
            parts = [nbrs, nn_all.reshape(B, m * m)]
        else:
            nn = torch.gather(nn_all, 2, rand["pick"][r0:r1]).reshape(B, -1)
            revb = rev[r0:r1]
            # neighbours of REVERSE neighbours: the standard local join
            # uses both edge directions
            rnn = torch.gather(graph[revb.reshape(-1)].reshape(B, nsn, m), 2,
                               rand["rpick"][r0:r1]).reshape(B, -1)
            parts = [nbrs, nn, revb, rnn]
        cand = torch.cat(parts + [rand["rnd"][r0:r1]], dim=1)
        ids, dist = _select_topk_sorted(
            vectors, sqn, vectors[r0:r1], torch.arange(r0, r1, device=dev),
            cand, out_m)
        ids_out.append(ids)
        d_out.append(dist)
    return torch.cat(ids_out), torch.cat(d_out)


# ---------------------------------------------------------------------------
# k-means: the bootstrap cells, the ladder, the start vertices


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


def _assign(vectors: torch.Tensor, cent: torch.Tensor, *,
            block: int) -> torch.Tensor:
    """Each vector's nearest centroid: argmin of |c|^2 - 2 v.c, the first
    on ties."""
    cn = (cent * cent).sum(dim=1)
    return torch.cat([
        torch.argmin(cn[None, :] - 2.0 * (vectors[b0:b0 + block] @ cent.T),
                     dim=1)
        for b0 in range(0, vectors.shape[0], block)])


def _lloyd_iter(vectors: torch.Tensor, cent: torch.Tensor, *,
                block: int) -> torch.Tensor:
    """One Lloyd iteration: assign each vector to its nearest centroid,
    then move each centroid with members to their mean."""
    labels = _assign(vectors, cent, block=block)
    sums, cnts = _lloyd_sums(vectors, labels, K=cent.shape[0], block=block)
    return torch.where(cnts[:, None] > 0,
                       sums / torch.clamp(cnts, min=1.0)[:, None], cent)


def _cell_members(labels, tie, offsets, *, K: int, n_real: int):
    """The bootstrap's member pick: every vertex's initial row is m random
    members of its own cell. Vertices sorted group-major by (label, tie
    bits); padded vertices get label K and sort last. offsets: (npad, m)
    in [0, 2^30). Returns (init (npad, m), labels, ids_s, starts, sizes)
    with sizes (K + 1,)."""
    npad = labels.shape[0]
    dev = labels.device
    labels = torch.where(torch.arange(npad, device=dev) < n_real,
                         labels.long(), K)
    ids_s = _sort_keyed(labels, tie)
    lab_s = labels[ids_s]
    starts = torch.searchsorted(lab_s, torch.arange(K + 1, device=dev))
    sizes = torch.diff(torch.cat([starts, starts.new_tensor([npad])]))
    cnt = torch.clamp(sizes[labels], min=1)
    idx = starts[labels][:, None] + offsets % cnt[:, None]
    init = ids_s[torch.clamp(idx, 0, npad - 1)]
    return init, labels, ids_s, starts, sizes


def _kmeans_bootstrap(vectors, init_ids, tie, offsets, *, K: int, iters: int,
                      block: int, n_real: int):
    """Locality-seeded initial graph: `iters` Lloyd iterations from the
    centroids vectors[init_ids] partition the space into K cells, then
    every vertex's initial row is m random members of its own cell
    (_cell_members). NN-descent from a random graph stalls at large n
    (1.1 % true-NN overlap after 5 rounds at n = 1e6 in the JAX package);
    from a locality-seeded graph it only has to refine.

    Returns (init (npad, m) ids, self entries possible, labels, cent, ids_s,
    starts, sizes)."""
    cent = vectors[init_ids]
    labels = _assign(vectors, cent, block=block)
    for _ in range(iters):
        # padded rows carry no weight in the JAX package's sums
        sums, cnts = _lloyd_sums(vectors[:n_real], labels[:n_real], K=K,
                                 block=block)
        cent = torch.where(cnts[:, None] > 0,
                           sums / torch.clamp(cnts, min=1.0)[:, None], cent)
        labels = _assign(vectors, cent, block=block)
    init, labels, ids_s, starts, sizes = _cell_members(
        labels, tie, offsets, K=K, n_real=n_real)
    return init, labels, cent, ids_s, starts, sizes


def _ladder_cells(labels, cent, *, L: int):
    """(npad, L): for each vertex, the cells ranked 2^j (j = 0..L-1) by
    centroid distance (|c|^2 - 2 c.c', stable order) from its own cell."""
    K = cent.shape[0]
    cn = (cent * cent).sum(dim=1)
    cd = cn[None, :] - 2.0 * (cent @ cent.T)             # (K, K)
    order = torch.sort(cd, dim=1, stable=True).indices   # row r: by distance
    ladder = torch.clamp(2 ** torch.arange(L, device=cd.device), max=K - 1)
    return order[:, ladder][torch.clamp(labels, max=K - 1)]


def _ladder_pick(cells, ids_s, starts, sizes, offsets):
    """One member of each of a vertex's ladder cells: offsets (npad, L) in
    [0, 2^30), taken modulo the cell's size."""
    npad = ids_s.shape[0]
    cnt = torch.clamp(sizes[cells], min=1)
    idx = starts[cells] + offsets % cnt
    return ids_s[torch.clamp(idx, 0, npad - 1)]


def _ladder_candidates(labels, cent, ids_s, starts, sizes, offsets, *,
                       L: int):
    """Kleinberg-style distance-stratified long-range candidates: for each
    vertex, one random member of the cell ranked 2^j (j = 0..L-1) by
    centroid distance from its own cell. Uniform random long edges do not
    support greedy routing at scale; a geometric ladder of scales does."""
    return _ladder_pick(_ladder_cells(labels, cent, L=L), ids_s, starts,
                        sizes, offsets)


def _nearest_vertex_device(vectors: torch.Tensor, cent: torch.Tensor, *,
                           block: int) -> torch.Tensor:
    """Nearest vertex id per centroid: a blocked running argmin (an earlier
    block keeps a tie)."""
    K = cent.shape[0]
    dev = vectors.device
    best_d = torch.full((K,), INF, device=dev)
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
    with cuda_lib.fp32_matmul(dev):
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


# ---------------------------------------------------------------------------
# vectorized robust prune


def _robust_prune_batch(vectors, u_ids, cand_ids, cand_valid, m: int,
                        keep: int = 0):
    """Greedy alpha-accept per vertex (build_graph.go:156-223), vectorized.

    cand_ids: (B, C) candidate ids (padded); cand_valid: (B, C) mask.
    Returns ((B, m) accepted ids, -1 padded, (B,) accept counts).

    Candidates in ascending distance to u (stable); candidate i is blocked
    if an accepted w has alpha * d(w, i) < d(u, i), pairwise distances by
    the dot identity clamped at 0. keep: the nearest `keep` distinct
    candidates are accepted unconditionally (alpha applies to the remaining
    slots): the pure alpha rule evicts a vertex's true nearest neighbours
    on dense manifolds, which caps recall@k. Then backfill from the
    discarded, in distance order (build_graph.go:199-213)."""
    B, C = cand_ids.shape
    d = vectors.shape[1]
    dev = vectors.device
    q = vectors[u_ids]                                    # (B, d)
    cv = vectors[cand_ids]                                # (B, C, d)
    d_u = ((cv - q[:, None, :]) ** 2).sum(dim=-1)         # dist to u
    d_u = torch.where(cand_valid, d_u, INF)
    du_sorted, order = torch.sort(d_u, dim=1, stable=True)
    cand_sorted = torch.gather(cand_ids, 1, order)
    cv = torch.gather(cv, 1, order[:, :, None].expand(B, C, d))
    sq = (cv * cv).sum(dim=-1)                            # (B, C)
    cross = torch.bmm(cv, cv.transpose(1, 2))
    del cv
    # pd[b, j, i] = max(sq_j + sq_i - 2 cross_ji, 0); alpha_t[b, i, j] =
    # ALPHA * pd[b, j, i], so step i reads one contiguous row
    alpha_t = (sq[:, :, None] + sq[:, None, :] - 2.0 * cross).clamp_(min=0.0)
    del cross
    alpha_t = (ALPHA * alpha_t).transpose(1, 2).contiguous()
    if keep:
        # duplicate ids (pool sections overlap) must not take reserved
        # slots: without alpha, a repeat of an accepted id is no longer
        # blocked (pd = 0 < du), so non-first occurrences are masked
        lower = torch.ones((C, C), dtype=torch.bool, device=dev).tril(-1)
        dup = ((cand_sorted[:, :, None] == cand_sorted[:, None, :])
               & lower).any(dim=2)
    finite = torch.isfinite(du_sorted)
    accepted = torch.zeros((B, C), dtype=torch.bool, device=dev)
    n_acc = torch.zeros((B,), dtype=torch.int64, device=dev)
    for i in range(C):
        blocked = (accepted & (alpha_t[:, i] < du_sorted[:, i:i + 1])).any(1)
        if keep:
            blocked = torch.where(n_acc < keep, False, blocked) | dup[:, i]
        ok = ~blocked & (n_acc < m) & finite[:, i]
        accepted[:, i] = ok
        n_acc += ok
    del alpha_t

    discarded = ~accepted & finite
    need = m - n_acc
    disc_rank = torch.cumsum(discarded, dim=1) - 1        # rank among them
    take_disc = discarded & (disc_rank < need[:, None])
    final = accepted | take_disc
    # accepted first in distance order, then the backfill
    col = torch.arange(C, device=dev)[None, :]
    key = torch.where(accepted, 0, torch.where(take_disc, 1, 2)) * C + col
    sel = torch.sort(torch.where(final, key, 3 * C + col),
                     dim=1).indices[:, :m]
    out = torch.gather(cand_sorted, 1, sel)
    cnt = final.sum(dim=1)
    out = torch.where(torch.arange(m, device=dev)[None, :] < cnt[:, None],
                      out, -1)
    return out, cnt


def _prune_row_bytes(C: int, d: int) -> int:
    """Scratch bytes a row of _robust_prune_batch holds at once: the
    gathered candidates twice, three (C, C) f32 tensors, the duplicate
    mask."""
    return C * d * 8 + C * C * 13 + C * 64


def _prune_device(vectors, wide_ids, wide_d, *, m: int, keep: int = 0):
    """Robust alpha-prune of the pools (B, C), finite distances valid,
    over as many rows at a time as fit -> (npad, m) ids (-1 padded)."""
    npad, C = wide_ids.shape
    dev = vectors.device
    out = []
    for r0, r1 in _chunks(npad, _prune_row_bytes(C, vectors.shape[1]), dev):
        pruned, _ = _robust_prune_batch(
            vectors, torch.arange(r0, r1, device=dev),
            torch.clamp(wide_ids[r0:r1], min=0),
            torch.isfinite(wide_d[r0:r1]), m, keep=keep)
        out.append(pruned)
    return torch.cat(out)


# ---------------------------------------------------------------------------
# degree regularization


def _conn_lists_device(pruned, uniform, tie, *, n_real: int, m: int,
                       cap: int):
    """Degree-regularization edge pipeline (build_graph.go:414-452):
    bidirectionalize, keep edge x->y with probability min(1.5m /
    inbound[y], 1), dedup, and scatter each vertex's survivors into a
    cap-bounded connection list (a random subset for mega-hubs, by the tie
    bits). uniform: (2 npad mw,) f32 in [0, 1), tie: (2 npad mw,) u32
    values, one an edge of [forward edges in row order ‖ their reverses].
    Returns (conn (npad, cap) ids -1 padded, counts (npad,) = min(list
    length, cap)). Rows >= n_real of `pruned` are ignored."""
    npad, mw = pruned.shape     # mw = row width; m only sets the keep prob
    dev = pruned.device
    SENT = n_real   # sentinel group: dropped edges sort last
    rows = torch.arange(npad, device=dev)[:, None].expand(npad, mw)
    valid = (pruned >= 0) & (rows < n_real)
    src = rows.reshape(-1)
    dst = torch.where(valid, pruned.long(), -1).reshape(-1)
    dst_c = torch.where(dst < 0, SENT, dst)
    bsrc = torch.cat([src, dst_c])
    bdst = torch.cat([dst_c, src])
    bad = (bsrc >= n_real) | (bdst >= n_real) | (bsrc == bdst)
    bsrc = torch.where(bad, SENT, bsrc)
    bdst = torch.clamp(bdst, max=SENT)
    inbound = torch.bincount(torch.where(bad, SENT, bdst),
                             minlength=n_real + 1).float()
    keepp = torch.clamp(1.5 * m / torch.clamp(inbound[bdst], min=1.0),
                        max=1.0)
    bsrc = torch.where(uniform >= keepp, SENT, bsrc)
    # dedup: sort by (src, dst), mask consecutive duplicates
    order = torch.sort((bsrc << 32) | bdst, stable=True).indices
    s1, d1 = bsrc[order], bdst[order]
    dup = torch.zeros_like(s1, dtype=torch.bool)
    dup[1:] = (s1[1:] == s1[:-1]) & (d1[1:] == d1[:-1])
    s1 = torch.where(dup, SENT, s1)
    # random within-group order, then rank -> capped scatter
    order = _sort_keyed(s1, tie)
    s2, d2 = s1[order], d1[order]
    starts = torch.searchsorted(s2, torch.arange(n_real + 1, device=dev))
    rank = torch.arange(s2.shape[0], device=dev) - starts[s2]
    put = (rank < cap) & (s2 < n_real)
    conn = torch.full((npad, cap), -1, dtype=torch.int64, device=dev)
    conn[s2[put], rank[put]] = d2[put]
    counts = torch.zeros(npad, dtype=torch.int64, device=dev)
    counts[:n_real] = torch.clamp(torch.diff(starts), max=cap)
    return conn, counts


def _prune_or_keep_device(vectors, conn, counts, *, m: int, keep: int = 0):
    """Over-degree vertices are robust-pruned down to m; vertices with <= m
    connections keep their list (build_graph.go:453-455). Mega-hub pools
    are first narrowed to the 4m nearest of their (random-capped) list.
    -> (npad, m) ids, -1 padded."""
    npad, cap = conn.shape
    d = vectors.shape[1]
    dev = vectors.device
    sqn = (vectors * vectors).sum(dim=1)
    ncap = min(cap, 4 * m)
    row_bytes = max(cap * (d * 4 + 40), _prune_row_bytes(ncap, d))
    out = []
    for r0, r1 in _chunks(npad, row_bytes, dev):
        ids = torch.arange(r0, r1, device=dev)
        cnd = conn[r0:r1]
        if ncap < cap:
            csel = torch.where(cnd >= 0, cnd, ids[:, None])  # self: masked
            nar, nar_d = _select_topk_sorted(vectors, sqn, vectors[r0:r1],
                                             ids, csel, ncap)
            valid = torch.isfinite(nar_d)
        else:
            nar, valid = cnd, cnd >= 0
        pruned, _ = _robust_prune_batch(vectors, ids,
                                        torch.clamp(nar, min=0), valid, m,
                                        keep=keep)
        out.append(torch.where((counts[r0:r1] <= m)[:, None], cnd[:, :m],
                               pruned))
    return torch.cat(out)


def _random_fill_device(out, fill, *, m: int):
    """Resample -1 slots with uniform ids, kill self edges and within-row
    duplicates (later occurrences), FILL_ROUNDS times. fill: (rounds, npad,
    m) ids in [0, n_real), round i's draw for row r at fill[i, r]. Rows
    still deficient after the rounds are left to the host mop-up
    (_random_fill)."""
    npad = out.shape[0]
    dev = out.device
    lower = torch.ones((m, m), dtype=torch.bool, device=dev).tril(-1)
    res = []
    for r0, r1 in _chunks(npad, m * m * 2 + m * 64, dev):
        sub = out[r0:r1]
        ids = torch.arange(r0, r1, device=dev)[:, None]
        for i in range(fill.shape[0]):
            sub = torch.where(sub < 0, fill[i, r0:r1], sub)
            sub = torch.where(sub == ids, -1, sub)
            eq = (sub[:, :, None] == sub[:, None, :]) & (sub >= 0)[:, :, None]
            sub = torch.where((eq & lower).any(dim=2), -1, sub)
        res.append(sub)
    return torch.cat(res)


def _degree_reg_device(vectors, pruned, uniform, tie, fill, *, n_real: int,
                       m: int, cap: int, keep: int):
    """Degree regularization and the device random fill, back to back."""
    conn, counts = _conn_lists_device(pruned, uniform, tie, n_real=n_real,
                                      m=m, cap=cap)
    out = _prune_or_keep_device(vectors, conn, counts, m=m, keep=keep)
    return _random_fill_device(out, fill, m=m)


def _random_fill(out: np.ndarray, m: int, rng,
                 verbose: bool = False) -> np.ndarray:
    """Random-fill every under-degree row to exactly m distinct non-self
    edges (build_graph.go:457-475). Host numpy, the JAX package's draws in
    its order on `rng`: the deficit set is tiny."""
    n = out.shape[0]
    # resample empty slots, invalidate self/duplicates, retry (converges in
    # a couple of rounds when n >> m); a scalar loop mops up stragglers
    need_rows = np.flatnonzero((out >= 0).sum(1) < m)
    if len(need_rows):
        sub = out[need_rows].copy()
        ids_col = need_rows[:, None]
        for _ in range(16):
            miss = sub < 0
            if not miss.any():
                break
            sub[miss] = rng.integers(0, n, size=int(miss.sum()))
            sub[sub == ids_col] = -1
            ordv = np.argsort(sub, axis=1, kind="stable")
            sv = np.take_along_axis(sub, ordv, axis=1)
            dup_s = np.zeros_like(sv, bool)
            dup_s[:, 1:] = (sv[:, 1:] == sv[:, :-1]) & (sv[:, 1:] >= 0)
            dup = np.zeros_like(dup_s)
            np.put_along_axis(dup, ordv, dup_s, axis=1)
            sub[dup] = -1
        out[need_rows] = sub
    for u in np.flatnonzero((out >= 0).sum(1) < m):  # rare stragglers
        have = set(int(x) for x in out[u] if x >= 0)
        while len(have) < m:
            v = int(rng.integers(0, n))
            if v != u:
                have.add(v)
        out[u] = sorted(have)[:m] if len(have) == m else list(have)[:m]

    if verbose:
        inb = np.bincount(out.reshape(-1), minlength=n)
        print(f"Min inbound: {inb.min()}, Max inbound: {inb.max()}")
    return out


# ---------------------------------------------------------------------------
# full pipeline

def _corridor_block(npad: int, m: int, step: int, par: int,
                    device: torch.device) -> int:
    """The corridor search's vertices a block: half the device's
    CHUNK_BYTES over a query's beam state (graph/beam.py: the visited
    table's ids, distances and neighbour rows, and a step's (B, cap)
    dedup mask)."""
    cap = par + step * par * m
    per_query = cap * (m + 3) * 4 + par * m * cap + par * m * 1024
    return max(1, min(npad, CHUNK_BYTES[device.type] // 2 // per_query))


def build_graph(vectors, m: int, *, rounds: int = 6, seed: int = 0,
                block: int = 2048, verbose: bool = False,
                quality_gate: bool | None = None, keep_nearest: int = 16,
                corridor_step: int = 16, corridor_par: int = 2,
                corridor_passes: int = 1,
                draws: dict | BuildDraws | None = None, device=None,
                stats: dict | None = None,
                record: dict | None = None) -> np.ndarray:
    """vectors (n, d) -> graph (n, m) int32 numpy, every row exactly m
    distinct non-self ids.

    vectors: numpy (u8, i8 and f16 are uploaded as they are and widened
    to f32 on the device; anything else becomes f32) or a tensor; they live
    on `device`: None means a tensor's own device, else the card (raising
    where CUDA is not available).

    block: the JAX package's logical block. It sets the padding, npad =
    ceil(n / min(block, n)) * min(block, n) rows of row-0 copies, and
    padded rows take part in the reverse sample and the connection lists,
    so it is kept; how many rows a pass computes at once is the port's own
    choice (CHUNK_BYTES) and never changes a result.

    quality_gate: run the post-build self-query probe (build_graph.go:102,
    764-805) and print hit rate and average steps; defaults to `verbose`.
    keep_nearest: reserved nearest-neighbour slots in the final prunes.
    corridor_step / corridor_par: the beam budget of the corridor search;
    corridor_passes: that many searches, each from a disjoint slice of the
    sqrt(n) random start ids, their corridors concatenated.

    draws: named draws handed in (a dict, or a BuildDraws that makes the
    others); the others are hashes of `seed` (BuildDraws). stats: a dict
    that receives "phases", the seconds of each phase ("phase_draw_seconds":
    of the draws made inside it), "draw_seconds" of all draws, "seconds",
    "gate" (hit rate, avg steps) or None, and on the card "peak_gb", its
    peak memory. record: a dict that receives, per stage, (fn, args,
    kwargs, output), for replaying a stage elsewhere."""
    t_start = time.perf_counter()
    dev = cuda_lib.default_device(vectors, device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    rng = np.random.default_rng(seed)
    dr = draws if isinstance(draws, BuildDraws) else BuildDraws(seed, draws)
    phases: dict[str, float] = {}
    phase_draws: dict[str, float] = {}
    stats = {} if stats is None else stats
    stats.update(phases=phases, phase_draw_seconds=phase_draws, gate=None)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def el():
        s = f"[{time.perf_counter() - t_start:.1f}s"
        if dev.type == "cuda":
            s += f" peak {torch.cuda.max_memory_allocated(dev) / 2**30:.1f}G"
        return s + "]"

    def stage(name, fn, *args, **kw):
        t0, d0 = time.perf_counter(), dr.seconds
        with cuda_lib.fp32_matmul(dev):
            out = fn(*args, **kw)
        sync()
        phases[name] = phases.get(name, 0.0) + time.perf_counter() - t0
        phase_draws[name] = phase_draws.get(name, 0.0) + dr.seconds - d0
        if record is not None:
            record[name] = (fn, args, kw, out)
        return out

    if isinstance(vectors, torch.Tensor):
        v = vectors.to(dev)
    else:
        v = torch.from_numpy(_compact_host(vectors)).to(dev)
    n, d = v.shape
    blk = min(block, n)
    npad = -(-n // blk) * blk
    v = v.float()
    if npad != n:
        v = torch.cat([v, v[:1].expand(npad - n, d)])
    v = v.contiguous()
    sqn = (v * v).sum(dim=1)
    n_far = max(8, m // 2)
    cand_local = int(1.5 * m) + m - n_far
    K = max(16, min(4096, n // 256))
    Lad = max(2, min(12, int(np.log2(max(K - 1, 4)))))
    n_starts = min(n, int(np.sqrt(n)))
    cap = max(8 * m, 256)
    ns_pass = max(1, n_starts // corridor_passes)
    nsn = 2
    rows = torch.arange(npad, device=dev)[:, None]
    if verbose:
        sync()
        print(f"vectors on device {el()}", flush=True)

    # phase 1: NN-descent from a locality-seeded (k-means cell) graph
    graph, labels, cent, ids_s, cstarts, csizes = stage(
        "bootstrap", _kmeans_bootstrap, v,
        dr.ints("bootstrap.init", (K,), n, dev),
        dr.bits("bootstrap.tie", (npad,), dev),
        dr.ints("bootstrap.offsets", (npad, m), 1 << 30, dev),
        K=K, iters=2, block=blk, n_real=n)
    if verbose:
        print(f"kmeans bootstrap done (K={K}) {el()}", flush=True)
    for r in range(rounds):
        rand = {"tie": dr.bits(f"descent{r}.tie", (npad * m,), dev),
                "fill": dr.ints(f"descent{r}.fill", (npad, nsn), n, dev),
                "pick": dr.ints(f"descent{r}.pick", (npad, m, nsn), m, dev),
                "rpick": dr.ints(f"descent{r}.rpick", (npad, nsn, 2 * nsn),
                                 m, dev),
                "rnd": dr.ints(f"descent{r}.rnd", (npad, 8), n, dev)}
        graph, rdist = stage(f"descent {r}", _nn_round_device, v, sqn, graph,
                             rand, nsn=nsn, n_random=8, n_real=n, out_m=m,
                             wide=False)
        del rand
        if verbose:
            # convergence probe: mean top-m distance over the real vertices
            md = float(torch.where(torch.isfinite(rdist[:n]), rdist[:n],
                                   0.0).mean())
            print(f"nn-descent round {r} done (mean top-{m} dist {md:.4f})"
                  f" {el()}", flush=True)
        del rdist

    # phase 2: candidate pool = the wide round's nearest locals ‖ corridors
    # ‖ ladder ‖ far randoms, appended unfiltered: the alpha-prune accepts a
    # far candidate when local slots run dry, which is how DiskANN keeps
    # its highway edges (a purely local graph is unnavigable)
    wide_ids, wide_d = stage(
        "wide", _nn_round_device, v, sqn, graph,
        {"rnd": dr.ints("wide.rnd", (npad, 16), n, dev)}, nsn=nsn,
        n_random=16, n_real=n, out_m=cand_local, wide=True)
    del graph
    if verbose:
        print(f"wide round done {el()}", flush=True)
    far = dr.ints("far", (npad, n_far), n, dev)
    far = torch.where(far == rows, (far + 1) % n, far)
    # far candidates are always valid (the prune recomputes distances)
    far_d = torch.zeros((npad, n_far), device=dev)

    # distance-stratified long-range candidates from the bootstrap cells
    ladder = stage("ladder", _ladder_candidates, labels, cent, ids_s,
                   cstarts, csizes,
                   dr.ints("ladder", (npad, Lad), 1 << 30, dev), L=Lad)
    del labels, cent, ids_s, cstarts, csizes
    ladder_d = torch.where(ladder != rows, 0.0, INF)
    if verbose:
        print(f"ladder done {el()}", flush=True)

    # 2a. temporary navigable graph: the alpha-prune of locals, ladder and
    # far randoms (the JAX package pads this pool with invalid columns to
    # the final pool's width to share one compiled program; invalid columns
    # are never accepted, so the port leaves them out)
    nav = stage("nav prune", _prune_device, v,
                torch.cat([wide_ids, ladder, far], dim=1),
                torch.cat([wide_d, ladder_d, far_d], dim=1), m=m,
                keep=keep_nearest)
    nav_fill = dr.ints("nav_fill", (npad, m), n, dev)
    nav_fill = torch.where(nav_fill == rows, (nav_fill + 1) % n, nav_fill)
    nav = torch.where(nav < 0, nav_fill, nav).to(torch.int32)
    del nav_fill
    if verbose:
        print(f"nav graph done {el()}", flush=True)

    # 2b. search-based candidates (the NGT/Vamana mechanism): beam-search
    # every vertex's own vector over the nav graph and keep the expansion
    # corridor; each pass from a disjoint slice of the (unordered) random
    # start ids
    from pacmann_tpu_torch.graph.beam import search_paths_all

    starts = torch.as_tensor(rng.choice(n, n_starts, replace=False),
                             dtype=torch.int64, device=dev)
    cblock = _corridor_block(npad, m, corridor_step, corridor_par, dev)
    paths = torch.cat([
        stage("corridors", search_paths_all, v, nav,
              starts[i * ns_pass:(i + 1) * ns_pass],
              dr.step_randoms(f"corridor{i}", npad,
                              (corridor_step, corridor_par, m), n, dev),
              n=n, m=m, max_step=corridor_step, parallel=corridor_par,
              block=cblock).long()
        for i in range(corridor_passes)], dim=1)
    del nav
    path_d = torch.where((paths >= 0) & (paths != rows), 0.0, INF)
    if verbose:
        print(f"path candidates done {el()}", flush=True)

    # 2c. final pool = locals ‖ corridors ‖ ladder ‖ far -> alpha-prune
    pruned = stage("final prune", _prune_device, v,
                   torch.cat([wide_ids, paths, ladder, far], dim=1),
                   torch.cat([wide_d, path_d, ladder_d, far_d], dim=1),
                   m=m, keep=keep_nearest)
    del wide_ids, wide_d, paths, path_d, ladder, ladder_d, far, far_d
    if verbose:
        print(f"widen+prune done {el()}", flush=True)

    # phase 3: degree regularization (build_graph.go:414-484) and the
    # device fill, then the host mop-up
    E2 = 2 * npad * m
    out = stage("degree reg + fill", _degree_reg_device, v, pruned,
                dr.uniform("degree.uniform", (E2,), dev),
                dr.bits("degree.tie", (E2,), dev),
                dr.ints("degree.fill", (FILL_ROUNDS, npad, m), n, dev),
                n_real=n, m=m, cap=cap, keep=keep_nearest)
    del pruned
    out = out[:n].cpu().numpy().astype(np.int64)
    if verbose:
        print(f"degree regularization + fill done {el()}", flush=True)
    t0 = time.perf_counter()
    graph = _random_fill(out, m, rng, verbose).astype(np.int32)
    phases["degree reg + fill"] += time.perf_counter() - t0
    stats["draw_seconds"] = dr.seconds
    if dev.type == "cuda":
        stats["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    if quality_gate is None:
        quality_gate = verbose
    if quality_gate:
        from pacmann_tpu_torch.graph.beam import PlaintextEngine
        from pacmann_tpu_torch.graph.recall import evaluate_graph_quality

        def gate_search(vecs, g, start_ids, queries, seed):
            return PlaintextEngine(vecs, g, start_ids=start_ids).search(
                queries, 20, 20, 2, seed=seed)

        # the padded f32 copy is already on the device: no second upload
        t0 = time.perf_counter()
        hit_rate, avg_steps = evaluate_graph_quality(
            v[:n], graph, num_queries=min(100, n), seed=seed,
            search_fn=gate_search)
        phases["gate"] = time.perf_counter() - t0
        stats["gate"] = (hit_rate, avg_steps)
        print(f"graph quality gate: self-query hit rate {hit_rate:.3f}, "
              f"avg steps {avg_steps:.1f}", flush=True)
    stats["seconds"] = time.perf_counter() - t_start
    return graph
