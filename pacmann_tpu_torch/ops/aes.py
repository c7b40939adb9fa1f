"""PRF offset tables: offset[p, t, s] = PRF_{key_p}(t, s) & chunk_mask.

The contract of the JAX package's prf_tables_pallas (ops/aes_pallas.py):
PRF(key, tag, x) = low32(AES-128-MMO_key(LE64((tag << 35) + x) || 0^8)),
on the hint-table lattice tag t in [0, T), chunk x = s in [0, S)
(pianopir/util.go:157-165, pir.go:226-251).

Two versions of one function:
  - prf_tables_plain: byte-wise AES with S-box table lookups on int64
    tensors, the structure of the host oracle (ops/aes_host.py);
  - aes_mmo_cuda: kernel K1 (csrc/aes_mmo.cu), T-tables in shared memory.
prf_tables routes a CPU tensor to the plain version and a CUDA tensor to
the kernel; there is no fallback between them.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from pacmann_tpu_torch.ops.aes_host import expand_key
from pacmann_tpu_torch.ops.gf2 import SBOX, gf_mul
from pacmann_tpu_torch.utils import cuda_lib

_SHIFT_ROWS = [(r + 4 * ((c + r) % 4)) for c in range(4) for r in range(4)]
_MUL2 = np.array([gf_mul(x, 2) for x in range(256)], dtype=np.int64)
_MUL3 = np.array([gf_mul(x, 3) for x in range(256)], dtype=np.int64)

# lattice points per plain-version step: bounds the (N, 16) int64 temporaries
_PLAIN_BLOCK = 1 << 21


def round_keys(keys16: list[bytes]) -> torch.Tensor:
    """AES-128 key schedule per partition -> (P, 11, 16) uint8 tensor."""
    return torch.from_numpy(np.stack([expand_key(k) for k in keys16]))


def _mix_columns(st: torch.Tensor, mul2, mul3) -> torch.Tensor:
    out = torch.empty_like(st)
    for c in range(4):
        a0, a1, a2, a3 = (st[:, 4 * c + r] for r in range(4))
        out[:, 4 * c + 0] = mul2[a0] ^ mul3[a1] ^ a2 ^ a3
        out[:, 4 * c + 1] = a0 ^ mul2[a1] ^ mul3[a2] ^ a3
        out[:, 4 * c + 2] = a0 ^ a1 ^ mul2[a2] ^ mul3[a3]
        out[:, 4 * c + 3] = mul3[a0] ^ a1 ^ a2 ^ mul2[a3]
    return out


def encrypt_blocks(rk: torch.Tensor, blocks: torch.Tensor) -> torch.Tensor:
    """Plain torch AES-128: rk (11, 16) round-key bytes, blocks (N, 16)
    bytes (any integer dtype) -> (N, 16) int64 ciphertext bytes."""
    dev = blocks.device
    keys = rk.to(device=dev, dtype=torch.int64)
    sbox = torch.as_tensor(SBOX, dtype=torch.int64, device=dev)
    mul2 = torch.as_tensor(_MUL2, device=dev)
    mul3 = torch.as_tensor(_MUL3, device=dev)
    shift = torch.as_tensor(_SHIFT_ROWS, dtype=torch.int64, device=dev)
    st = blocks.to(torch.int64) ^ keys[0]
    for r in range(1, 10):
        st = _mix_columns(sbox[st][:, shift], mul2, mul3) ^ keys[r]
    return sbox[st][:, shift] ^ keys[10]


def prf_tables_plain(rk: torch.Tensor, T: int, S: int,
                     chunk_mask: int) -> torch.Tensor:
    """Plain torch version: rk (P, 11, 16) uint8 round keys -> (P, T, S)
    int32 offsets. Evaluates the lattice in blocks of _PLAIN_BLOCK points."""
    dev = rk.device
    P = rk.shape[0]
    byte_sh = torch.arange(4, dtype=torch.int64, device=dev) * 8
    n = T * S
    out = torch.empty((P, n), dtype=torch.int32, device=dev)
    for lo in range(0, n, _PLAIN_BLOCK):
        i = torch.arange(lo, min(n, lo + _PLAIN_BLOCK), dtype=torch.int64,
                         device=dev)
        x = i % S
        hi = (i // S) << 3                    # (tag << 35) + x, high word
        block = torch.zeros((i.numel(), 16), dtype=torch.int64, device=dev)
        block[:, 0:4] = (x[:, None] >> byte_sh) & 0xFF
        block[:, 4:8] = (hi[:, None] >> byte_sh) & 0xFF
        for p in range(P):
            st = encrypt_blocks(rk[p], block) ^ block  # MMO feed-forward
            low = (st[:, 0:4] << byte_sh).sum(dim=1)
            out[p, lo:lo + i.numel()] = (low & chunk_mask).to(torch.int32)
    return out.reshape(P, T, S)


def aes_mmo_cuda(rk: torch.Tensor, T: int, S: int,
                 chunk_mask: int) -> torch.Tensor:
    """Kernel K1: rk (P, 11, 16) uint8 CUDA round keys -> (P, T, S) int32.
    Counts its launches in aes_mmo_cuda.launches."""
    cuda_lib.require_cuda_tensor(rk, "round keys", torch.uint8)
    P = rk.shape[0]
    if tuple(rk.shape[1:]) != (11, 16):
        raise ValueError(f"round keys must be (P, 11, 16), got {rk.shape}")
    if T * S >= 1 << 31:
        raise ValueError(f"T*S = {T * S} exceeds the kernel's 2^31 lattice")
    if not 0 <= chunk_mask < 1 << 32:
        raise ValueError(f"chunk_mask {chunk_mask} is not a u32")
    words = rk.reshape(P, 44 * 4).view(torch.int32)   # little-endian words
    out = torch.empty((P, T, S), dtype=torch.int32, device=rk.device)
    fn = cuda_lib.function("aes_mmo", "aes_mmo_tables", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_uint, ctypes.c_void_p])
    cuda_lib.check(
        fn(words.data_ptr(), out.data_ptr(), P, T, S, chunk_mask,
           cuda_lib.stream_ptr(rk.device)), "aes_mmo_tables")
    aes_mmo_cuda.launches += 1
    return out


aes_mmo_cuda.launches = 0


def prf_tables(rk: torch.Tensor, T: int, S: int,
               chunk_mask: int) -> torch.Tensor:
    """(P, 11, 16) uint8 round keys -> (P, T, S) int32 PRF offset tables:
    the plain version for a CPU tensor, kernel K1 for a CUDA tensor."""
    if rk.device.type == "cpu":
        return prf_tables_plain(rk, T, S, chunk_mask)
    return aes_mmo_cuda(rk, T, S, chunk_mask)
