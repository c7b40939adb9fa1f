"""GF(2^8) arithmetic and the AES S-box, derived from the field.

The part of the JAX package's ops/gf2.py that the host AES oracle
(ops/aes_host.py) needs. The bit-matrix machinery there exists for the
bitsliced TPU circuit; the Hopper kernel and its plain twin use byte
lookups instead, so it is not carried over.
"""

import numpy as np

AES_POLY = 0x11B  # x^8 + x^4 + x^3 + x + 1


def gf_mul(a: int, b: int) -> int:
    r = 0
    while b:
        if b & 1:
            r ^= a
        a <<= 1
        if a & 0x100:
            a ^= AES_POLY
        b >>= 1
    return r


def gf_pow(a: int, e: int) -> int:
    r = 1
    while e:
        if e & 1:
            r = gf_mul(r, a)
        a = gf_mul(a, a)
        e >>= 1
    return r


_AFFINE_C = 0x63


def _affine(x: int) -> int:
    y = 0
    for o in range(8):
        b = 0
        for t in (0, 4, 5, 6, 7):
            b ^= (x >> ((o + t) % 8)) & 1
        y |= b << o
    return y ^ _AFFINE_C


def sbox_table() -> np.ndarray:
    """The AES S-box derived from the field (no hardcoded table)."""
    t = np.zeros(256, dtype=np.uint8)
    for x in range(256):
        inv = gf_pow(x, 254) if x else 0
        t[x] = _affine(inv)
    return t


SBOX = sbox_table()
