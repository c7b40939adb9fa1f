"""Vectors near a low-dimensional linear manifold, made from --seed and
remade by id: the data of the deployment whose graph the server builds in
set-up (configs/sift1m_built.json).

Vector `id` of seed s has `dim` u8-valued components

    clip(rint(128 + 32 * z . B / sqrt(LATENT)), 0, 255)

(chip_smoke.py's manifold_vectors form): B, a (LATENT, dim) basis of
standard normals drawn from the seed; z, the id's LATENT latent draws. Each
z_j is an Irwin-Hall sum of DRAWS uniforms less DRAWS / 2 (mean 0, variance
1), the uniforms 24-bit words hashed from (seed, id, column) as
pbench/data.py hashes a row's words. The sum is taken in integers and the
product z . B in float64, one latent dimension at a time as separate
operations, so the same id gives the same vector on any device and in any
batch of ids: the reference remakes any row by itself.

Queries take the same form, their words drawn from numpy's generator keyed
by (seed, request): fresh points of the manifold, not database rows.
"""

from __future__ import annotations

import numpy as np
import torch

from pbench import data

LATENT = 12         # the manifold's dimension
DRAWS = 12          # uniforms summed a latent draw
SPREAD = 32.0       # a component's spread around 128
WORD_BITS = 24
# the tags of the seed's streams, apart from pbench/data.py's
VECTORS, BASIS, QUERIES, BUILD = range(16, 20)


def basis(seed: int, dim: int) -> np.ndarray:
    """(LATENT, dim) float64: the seed's basis, scaled by SPREAD /
    sqrt(LATENT)."""
    b = data.rng(seed, BASIS).standard_normal((LATENT, dim))
    return b * (SPREAD / np.sqrt(LATENT))


def from_words(words: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(B, LATENT * DRAWS) int64 words below 2^WORD_BITS and the scaled
    basis (LATENT, dim) float64 -> (B, dim) uint8 vectors."""
    s = words.reshape(-1, LATENT, DRAWS).sum(dim=-1)
    z = (s - (DRAWS << (WORD_BITS - 1))).double() * 2.0 ** -WORD_BITS
    acc = torch.zeros((z.shape[0], b.shape[1]), dtype=torch.float64,
                      device=words.device)
    for j in range(LATENT):
        acc = acc + z[:, j:j + 1] * b[j]
    return torch.round(acc + 128.0).clamp_(0, 255).to(torch.uint8)


def vectors(gid: torch.Tensor, *, seed: int, n: int,
            dim: int) -> torch.Tensor:
    """(len(gid), dim) uint8: the vectors of ids gid, on gid's device."""
    cols = LATENT * DRAWS
    if n * cols > 1 << 32:
        raise ValueError(f"{n} vectors of {cols} words exceed the 32-bit "
                         "word index the hash takes")
    salt = tuple(int(w) for w in np.random.SeedSequence(
        [data.seed_words(seed), VECTORS]).generate_state(2, np.uint32))
    words = data.word_hash(gid, cols, salt) >> (32 - WORD_BITS)
    b = torch.as_tensor(basis(seed, dim), device=gid.device)
    return from_words(words, b)


def make_vectors(n: int, *, seed: int, dim: int, device) -> torch.Tensor:
    """All n vectors, (n, dim) uint8, made on `device` in blocks."""
    out = torch.empty((n, dim), dtype=torch.uint8, device=device)
    for lo in range(0, n, data.ROW_BLOCK):
        hi = min(n, lo + data.ROW_BLOCK)
        out[lo:hi] = vectors(torch.arange(lo, hi, device=device), seed=seed,
                             n=n, dim=dim)
    return out


def query_vectors(seed: int, i: int, group: int, dim: int) -> np.ndarray:
    """Request i's (group, dim) float32 query vectors (u8-valued)."""
    words = data.rng(seed, QUERIES, i).integers(
        0, 1 << WORD_BITS, size=(group, LATENT * DRAWS))
    b = torch.from_numpy(basis(seed, dim))
    return from_words(torch.from_numpy(words), b).numpy().astype(np.float32)

