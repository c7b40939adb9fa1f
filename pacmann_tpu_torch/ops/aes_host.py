"""Host-side (NumPy) AES-128 reference + key schedule.

Used for (a) expanding the 16-byte master key into round keys on the host —
the reference likewise runs `expandKeyAsm` on the CPU before kernel calls
(pianopir/util.go:147-171) — and (b) as the correctness oracle
for the PRF-table kernel and its plain twin in ops/aes.py.

The PRF construction matches the reference exactly:
  PRF(longKey, tag, x) = low-8-bytes-LE( AES128-MMO(longKey, LE64((tag<<35)+x) || 0^8) )
  MMO(k, m) = E_k(m) ^ m
(pianopir/util.go:157-165, aes_amd64.s:51-82).
"""

import numpy as np

from pacmann_tpu_torch.ops.gf2 import SBOX, gf_mul

_RCON = [0x01, 0x02, 0x04, 0x08, 0x10, 0x20, 0x40, 0x80, 0x1B, 0x36]


def expand_key(key: bytes) -> np.ndarray:
    """AES-128 key schedule -> (11, 16) uint8 round keys (byte order = block order)."""
    assert len(key) == 16
    w = [list(key[4 * i : 4 * i + 4]) for i in range(4)]
    for i in range(4, 44):
        t = list(w[i - 1])
        if i % 4 == 0:
            t = t[1:] + t[:1]                      # RotWord
            t = [int(SBOX[b]) for b in t]          # SubWord
            t[0] ^= _RCON[i // 4 - 1]
        w.append([a ^ b for a, b in zip(w[i - 4], t)])
    rk = np.array(w, dtype=np.uint8).reshape(11, 16)
    return rk


def _sub_bytes(s):
    return SBOX[s]


_SHIFT_ROWS_PERM = np.array(
    [(r + 4 * ((c + r) % 4)) for c in range(4) for r in range(4)], dtype=np.int64
)


def _shift_rows(s):
    return s[..., _SHIFT_ROWS_PERM]


_MUL2 = np.array([gf_mul(x, 2) for x in range(256)], dtype=np.uint8)
_MUL3 = np.array([gf_mul(x, 3) for x in range(256)], dtype=np.uint8)


def _mix_columns(s):
    out = np.empty_like(s)
    for c in range(4):
        a0, a1, a2, a3 = (s[..., 4 * c + r] for r in range(4))
        out[..., 4 * c + 0] = _MUL2[a0] ^ _MUL3[a1] ^ a2 ^ a3
        out[..., 4 * c + 1] = a0 ^ _MUL2[a1] ^ _MUL3[a2] ^ a3
        out[..., 4 * c + 2] = a0 ^ a1 ^ _MUL2[a2] ^ _MUL3[a3]
        out[..., 4 * c + 3] = _MUL3[a0] ^ a1 ^ a2 ^ _MUL2[a3]
    return out


def aes128_encrypt(round_keys: np.ndarray, blocks: np.ndarray) -> np.ndarray:
    """Encrypt blocks (..., 16) uint8 with round keys from expand_key."""
    s = blocks ^ round_keys[0]
    for r in range(1, 10):
        s = _mix_columns(_shift_rows(_sub_bytes(s))) ^ round_keys[r]
    s = _shift_rows(_sub_bytes(s)) ^ round_keys[10]
    return s


def aes128_mmo(round_keys: np.ndarray, blocks: np.ndarray) -> np.ndarray:
    """Matyas-Meyer-Oseas: E_k(m) ^ m (aes_amd64.s:51-82)."""
    return aes128_encrypt(round_keys, blocks) ^ blocks


def prf_blocks(tags: np.ndarray, xs: np.ndarray) -> np.ndarray:
    """Build PRF input blocks (..., 16) u8 = LE64((tag<<35)+x) || zeros.

    tag < 2^29 (util.go:161); x < 2^32 in all protocol uses (chunk ids), so
    (tag<<35)+x never carries between the low and high u32 halves.
    """
    tags = np.asarray(tags, dtype=np.uint64)
    xs = np.asarray(xs, dtype=np.uint64)
    v = (tags << np.uint64(35)) + xs
    out = np.zeros(v.shape + (16,), dtype=np.uint8)
    for b in range(8):
        out[..., b] = ((v >> np.uint64(8 * b)) & np.uint64(0xFF)).astype(np.uint8)
    return out


def prf_eval_u64(round_keys: np.ndarray, tags, xs) -> np.ndarray:
    """Full-width reference PRF: LE u64 of the first 8 MMO output bytes."""
    blocks = prf_blocks(tags, xs)
    out = aes128_mmo(round_keys, blocks)
    v = np.zeros(out.shape[:-1], dtype=np.uint64)
    for b in range(8):
        v |= out[..., b].astype(np.uint64) << np.uint64(8 * b)
    return v
