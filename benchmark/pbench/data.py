"""The benchmark's inputs, all made from --seed.

A vertex row is `dim` float32 words in [0, 1) then `m` neighbour ids
uniform in [0, n): bench.py's synth_raw contract. Each word is a hash of
(seed, id, column), chip_smoke.py's shard_entries formula (the SIFT100M
shard's rows) made seedable: the 32-bit word index id * (dim + m) + column
goes through two rounds of MurmurHash3's fmix32, salted by two words drawn
from the seed. fmix32 is a bijection on 32 bits, so no two words of one
seed share a hash. The rows are hashed on the device in blocks, so set-up
makes a deployment's rows in a fraction of a second and the reference can
hash any row again on its own.

Everything else a run draws (query vectors, start vertices, the search
generator's seeds, the engine's rng, the check's samples) comes from numpy
SeedSequences keyed by (seed, TAG, index), so the same seed gives the same
inputs and runs with different seeds do the same amount of work.
"""

from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF
FMIX_C1, FMIX_C2 = 0x85EBCA6B, 0xC2B2AE35
ROW_BLOCK = 1 << 18          # rows hashed per block: bounds the temporaries

# the tags of the seed's streams (SeedSequence([seed, TAG, ...]))
SALT, QUERIES, SEARCH_GEN, STARTS, ENGINE, PREP, SAMPLE, TRACE = range(8)


def seed_words(seed: int) -> int:
    """--seed as a SeedSequence entropy word (any whole number)."""
    return int(seed) % 2**64


def rng(seed: int, *tags: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([seed_words(seed), *tags]))


def sub_seed(seed: int, *tags: int) -> int:
    """A 63-bit seed for a torch.Generator, from (seed, tags)."""
    w = np.random.SeedSequence([seed_words(seed), *tags]).generate_state(
        2, np.uint32)
    return (int(w[0]) << 31) ^ int(w[1])


def salts(seed: int) -> tuple[int, int]:
    a, b = np.random.SeedSequence([seed_words(seed), SALT]).generate_state(
        2, np.uint32)
    return int(a), int(b)


def mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """Low 32 bits of a * c for int64 tensors a in [0, 2^32) and c < 2^32,
    without int64 overflow (chip_smoke.py's mul32)."""
    return (a * (c & 0xFFFF) + (((a * (c >> 16)) & 0xFFFF) << 16)) & M32


def fmix32(h: torch.Tensor) -> torch.Tensor:
    """MurmurHash3's 32-bit finalizer on int64 tensors holding u32."""
    h = h ^ (h >> 16)
    h = mul32(h, FMIX_C1)
    h = h ^ (h >> 13)
    h = mul32(h, FMIX_C2)
    return h ^ (h >> 16)


def word_hash(gidx: torch.Tensor, n_cols: int, salt: tuple[int, int]):
    """(len(gidx), n_cols) int64 u32 hashes of every word of rows gidx."""
    col = torch.arange(n_cols, dtype=torch.int64, device=gidx.device)
    x = (gidx.long()[:, None] * n_cols + col) & M32
    return fmix32(fmix32(x ^ salt[0]) ^ salt[1])


def rows(gidx: torch.Tensor, *, n: int, dim: int, m: int,
         salt: tuple[int, int]) -> torch.Tensor:
    """(len(gidx), dim + m) int32 rows of vertices gidx: dim float32 bit
    patterns in [0, 1) (24 random bits each), then m neighbour ids in
    [0, n)."""
    if n * (dim + m) > 1 << 32:
        raise ValueError(f"{n} rows of {dim + m} words exceed the 32-bit "
                         "word index the hash takes")
    h = word_hash(gidx, dim + m, salt)
    vec = ((h[:, :dim] >> 8).to(torch.float32) * 2.0 ** -24).view(
        torch.int32)
    nbr = (h[:, dim:] % n).to(torch.int32)
    return torch.cat([vec, nbr], dim=1)


def make_rows(n: int, *, dim: int, m: int, seed: int,
              device) -> torch.Tensor:
    """All n rows, (n, dim + m) int32, hashed on `device` in blocks."""
    salt = salts(seed)
    out = torch.empty((n, dim + m), dtype=torch.int32, device=device)
    for lo in range(0, n, ROW_BLOCK):
        hi = min(n, lo + ROW_BLOCK)
        out[lo:hi] = rows(torch.arange(lo, hi, device=device), n=n, dim=dim,
                          m=m, salt=salt)
    return out


def query_vectors(seed: int, i: int, group: int, dim: int) -> np.ndarray:
    """Request i's (group, dim) float32 query vectors in [0, 1)."""
    return rng(seed, QUERIES, i).random((group, dim), dtype=np.float32)


def start_ids(seed: int, n: int, count: int) -> np.ndarray:
    """The search's start vertices: `count` distinct ids drawn from the
    seed (bench.py's rng.choice(n, min(1000, sqrt(n))))."""
    return np.sort(rng(seed, STARTS).choice(n, count, replace=False))


HASH_WEIGHT_BITS = 20


def entry_weights(words: int, device) -> torch.Tensor:
    """(words, 2) int64 weights below 2^20 of the two word-weighted sums
    that fingerprint a fetched entry (fixed, not seeded)."""
    w = np.random.default_rng(0x5EED).integers(
        1, 1 << HASH_WEIGHT_BITS, size=(words, 2))
    return torch.as_tensor(w, dtype=torch.int64, device=device)


def entry_hash(entries: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """(..., words) int32 entries -> (..., 2) int64: two weighted sums of
    the u32 words, exact in int64 for up to 2,048 words. Two different
    entries share both sums with a chance of about 2^-40."""
    u = entries.long() & M32
    return torch.stack([(u * weights[:, 0]).sum(-1),
                        (u * weights[:, 1]).sum(-1)], dim=-1)
