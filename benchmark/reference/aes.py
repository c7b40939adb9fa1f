"""AES-128 (FIPS-197) and the protocol's PRF, in plain numpy and torch.

PRF(key, tag, x) = low 32 bits of AES-128-MMO_key(LE64((tag << 35) + x)
|| 0^8), MMO(k, m) = E_k(m) ^ m (the reference's pianopir/util.go:157-165),
masked to the chunk. `rounds` below 10 gives AES cut short (the last
round without MixColumns, under round key `rounds`): the benchmark's
control, a cheaper PRF than the configuration states.
"""

from __future__ import annotations

import numpy as np
import torch


def _gf_mul(a: int, b: int) -> int:
    out = 0
    while b:
        if b & 1:
            out ^= a
        a = ((a << 1) ^ (0x11B if a & 0x80 else 0)) & 0xFF
        b >>= 1
    return out


def _sbox() -> np.ndarray:
    box = np.zeros(256, np.int64)
    for x in range(256):
        inv = 0
        if x:
            inv = 1
            for _ in range(254):              # x^254 = x^-1 in GF(2^8)
                inv = _gf_mul(inv, x)
        s = inv
        for r in range(1, 5):
            s ^= ((inv << r) | (inv >> (8 - r))) & 0xFF
        box[x] = s ^ 0x63
    return box


SBOX = _sbox()
RCON = (0x01, 0x02, 0x04, 0x08, 0x10, 0x20, 0x40, 0x80, 0x1B, 0x36)
# state byte 4c + r is row r of column c; ShiftRows moves row r left by r
SHIFT_ROWS = [r + 4 * ((c + r) % 4) for c in range(4) for r in range(4)]


def expand_key(key: bytes) -> np.ndarray:
    """The AES-128 key schedule: 16 key bytes -> (11, 16) round-key bytes."""
    w = [list(key[4 * i:4 * i + 4]) for i in range(4)]
    for i in range(4, 44):
        t = list(w[i - 1])
        if i % 4 == 0:
            t = [int(SBOX[b]) for b in t[1:] + t[:1]]
            t[0] ^= RCON[i // 4 - 1]
        w.append([a ^ b for a, b in zip(w[i - 4], t)])
    return np.array(w, np.int64).reshape(11, 16)


def encrypt(rk: torch.Tensor, blocks: torch.Tensor,
            rounds: int = 10) -> torch.Tensor:
    """rk (..., 11, 16) int64 round keys, blocks (..., N, 16) int64 bytes ->
    (..., N, 16) ciphertext bytes."""
    dev = blocks.device
    sbox = torch.as_tensor(SBOX, device=dev)
    shift = torch.as_tensor(SHIFT_ROWS, device=dev)
    s = blocks ^ rk[..., 0:1, :]
    for r in range(1, rounds + 1):
        s = sbox[s][..., shift]
        if r < rounds:
            a = s.unflatten(-1, (4, 4))                  # (..., col, row)
            x = ((a << 1) ^ ((a >> 7) * 0x1B)) & 0xFF    # 2 * a
            rot = a.roll(-1, -1)                         # a[r + 1]
            xrot = x.roll(-1, -1)
            # b[r] = 2a[r] ^ 3a[r+1] ^ a[r+2] ^ a[r+3]
            s = (x ^ xrot ^ rot ^ a.roll(-2, -1) ^ a.roll(-3, -1)).flatten(-2)
        s = s ^ rk[..., r:r + 1, :]
    return s


def prf(rk: torch.Tensor, tags: torch.Tensor, xs: torch.Tensor, mask: int,
        rounds: int = 10) -> torch.Tensor:
    """rk (P, 11, 16) int64, tags and xs (P, N) int64 (tag < 2^29, x <
    2^32) -> (P, N) int64 PRF values & mask."""
    sh = torch.arange(4, device=xs.device) * 8
    block = torch.zeros(xs.shape + (16,), dtype=torch.int64,
                        device=xs.device)
    block[..., 0:4] = (xs[..., None] >> sh) & 0xFF
    block[..., 4:8] = ((tags[..., None] << 3) >> sh) & 0xFF
    out = encrypt(rk, block, rounds) ^ block
    return (out[..., 0:4] << sh).sum(-1) & mask
