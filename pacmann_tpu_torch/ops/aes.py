"""The AES-128-MMO PRF with per-partition keys (pianopir/util.go:157-165):
PRF(key, tag, x) = low32(AES-128-MMO_key(LE64((tag << 35) + x) || 0^8)).

Two contracts of the JAX package's ops/aes_pallas.py:
  - prf_tables (prf_tables_pallas): offset tables offset[p, t, s] =
    PRF_{key_p}(t, s) & chunk_mask on the hint-table lattice t in [0, T),
    chunk x = s in [0, S) (pir.go:226-251);
  - prf_eval (prf_eval_fused_pallas, the same as aes.prf_eval_fused): the
    table-free client's online PRF on per-partition point lists,
    out[p, l] = PRF_{key_p}(tags[p, l], xs[p, l]) & chunk_mask
    (pir.go:404-427).

Two versions of each:
  - prf_tables_plain / prf_eval_plain: byte-wise AES with S-box table
    lookups on int64 tensors, the structure of the host oracle
    (ops/aes_host.py);
  - aes_mmo_cuda / aes_mmo_points_cuda: kernels K1 and K5
    (csrc/aes_mmo.cu), one block setup and round function: 32 lane copies
    of the T-tables Te0 and Te2 in shared memory, round keys in registers.
prf_tables and prf_eval route a CPU tensor to the plain version and a CUDA
tensor to the kernel; there is no fallback between them.

prf_tables_native is the host tier's table, which the engines take on the
CPU where native_lib is available (the JAX package's
prf_offset_table_device on a CPU backend); elsewhere they call
prf_tables.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from pacmann_tpu_torch import native_lib
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


def _mmo_low32(rk: torch.Tensor, x: torch.Tensor,
               hi: torch.Tensor) -> torch.Tensor:
    """Low word of AES-128-MMO under one key: rk (11, 16) round keys, x and
    hi (N,) int64 u32 values, the block's words 0 and 1 -> (N,) int64."""
    dev = x.device
    byte_sh = torch.arange(4, dtype=torch.int64, device=dev) * 8
    block = torch.zeros((x.numel(), 16), dtype=torch.int64, device=dev)
    block[:, 0:4] = (x[:, None] >> byte_sh) & 0xFF
    block[:, 4:8] = (hi[:, None] >> byte_sh) & 0xFF
    st = encrypt_blocks(rk, block) ^ block           # MMO feed-forward
    return (st[:, 0:4] << byte_sh).sum(dim=1)


def prf_tables_plain(rk: torch.Tensor, T: int, S: int,
                     chunk_mask: int) -> torch.Tensor:
    """Plain torch version of K1: rk (P, 11, 16) uint8 round keys ->
    (P, T, S) int32 offsets. Evaluates the lattice in blocks of _PLAIN_BLOCK
    points."""
    dev = rk.device
    P = rk.shape[0]
    n = T * S
    out = torch.empty((P, n), dtype=torch.int32, device=dev)
    for lo in range(0, n, _PLAIN_BLOCK):
        i = torch.arange(lo, min(n, lo + _PLAIN_BLOCK), dtype=torch.int64,
                         device=dev)
        x = i % S
        hi = (i // S) << 3                    # (tag << 35) + x, high word
        for p in range(P):
            low = _mmo_low32(rk[p], x, hi)
            out[p, lo:lo + i.numel()] = (low & chunk_mask).to(torch.int32)
    return out.reshape(P, T, S)


def prf_eval_plain(rk: torch.Tensor, tags: torch.Tensor, xs: torch.Tensor,
                   chunk_mask: int) -> torch.Tensor:
    """Plain torch version of K5: rk (P, 11, 16) uint8 round keys, tags and
    xs (P, L) int32 (u32 bits) -> (P, L) int32 PRF values & chunk_mask.
    Evaluates each partition's points in blocks of _PLAIN_BLOCK."""
    P, L = tags.shape
    out = torch.empty((P, L), dtype=torch.int32, device=tags.device)
    for lo in range(0, L, _PLAIN_BLOCK):
        hi_l = min(L, lo + _PLAIN_BLOCK)
        for p in range(P):
            x = xs[p, lo:hi_l].long() & 0xFFFFFFFF
            # the u32 shift of the TPU kernel: tag bits above 28 drop out
            hi = (tags[p, lo:hi_l].long() << 3) & 0xFFFFFFFF
            low = _mmo_low32(rk[p], x, hi)
            out[p, lo:hi_l] = (low & chunk_mask).to(torch.int32)
    return out


def _check_round_keys(rk: torch.Tensor) -> int:
    cuda_lib.require_cuda_tensor(rk, "round keys", torch.uint8)
    if rk.dim() != 3 or tuple(rk.shape[1:]) != (11, 16):
        raise ValueError(f"round keys must be (P, 11, 16), got {rk.shape}")
    return rk.shape[0]


def _check_mask(chunk_mask: int):
    if not 0 <= chunk_mask < 1 << 32:
        raise ValueError(f"chunk_mask {chunk_mask} is not a u32")


def aes_mmo_cuda(rk: torch.Tensor, T: int, S: int,
                 chunk_mask: int) -> torch.Tensor:
    """Kernel K1: rk (P, 11, 16) uint8 CUDA round keys -> (P, T, S) int32.
    Counts its launches in aes_mmo_cuda.launches."""
    P = _check_round_keys(rk)
    if T * S >= 1 << 31:
        raise ValueError(f"T*S = {T * S} exceeds the kernel's 2^31 lattice")
    _check_mask(chunk_mask)
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


def aes_mmo_points_cuda(rk: torch.Tensor, tags: torch.Tensor,
                        xs: torch.Tensor, chunk_mask: int) -> torch.Tensor:
    """Kernel K5: prf_eval_plain's contract on CUDA tensors. Counts its
    launches in aes_mmo_points_cuda.launches."""
    P = _check_round_keys(rk)
    cuda_lib.require_cuda_tensor(tags, "tags", torch.int32)
    cuda_lib.require_cuda_tensor(xs, "xs", torch.int32)
    if tags.dim() != 2 or tags.shape[0] != P or xs.shape != tags.shape \
            or tags.device != rk.device or xs.device != rk.device:
        raise ValueError(f"tags {tuple(tags.shape)} on {tags.device} and xs "
                         f"{tuple(xs.shape)} on {xs.device} must both be "
                         f"(P={P}, L) on {rk.device}")
    L = tags.shape[1]
    if L >= 1 << 31:
        raise ValueError(f"L = {L} exceeds the kernel's 2^31 points")
    _check_mask(chunk_mask)
    out = torch.empty((P, L), dtype=torch.int32, device=rk.device)
    if P == 0 or L == 0:
        return out
    words = rk.reshape(P, 44 * 4).view(torch.int32)   # little-endian words
    fn = cuda_lib.function("aes_mmo", "aes_mmo_points", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_uint, ctypes.c_void_p])
    cuda_lib.check(
        fn(words.data_ptr(), tags.data_ptr(), xs.data_ptr(), out.data_ptr(),
           P, L, chunk_mask, cuda_lib.stream_ptr(rk.device)),
        "aes_mmo_points")
    aes_mmo_points_cuda.launches += 1
    return out


aes_mmo_points_cuda.launches = 0


def prf_tables(rk: torch.Tensor, T: int, S: int,
               chunk_mask: int) -> torch.Tensor:
    """(P, 11, 16) uint8 round keys -> (P, T, S) int32 PRF offset tables:
    the plain version for a CPU tensor, kernel K1 for a CUDA tensor."""
    if rk.device.type == "cpu":
        return prf_tables_plain(rk, T, S, chunk_mask)
    return aes_mmo_cuda(rk, T, S, chunk_mask)


def prf_eval(rk: torch.Tensor, tags: torch.Tensor, xs: torch.Tensor,
             chunk_mask: int) -> torch.Tensor:
    """(P, 11, 16) uint8 round keys, (P, L) int32 tags and xs -> (P, L)
    int32 PRF values & chunk_mask: the plain version for a CPU tensor,
    kernel K5 for a CUDA tensor."""
    if rk.device.type == "cpu":
        return prf_eval_plain(rk, tags, xs, chunk_mask)
    return aes_mmo_points_cuda(rk, tags, xs, chunk_mask)


def prf_tables_native(rk: torch.Tensor, T: int, S: int,
                      chunk_mask: int) -> torch.Tensor:
    """prf_tables' contract on CPU round keys through the host tier:
    native_lib's AES-NI table per partition (the caller checks
    native_lib.host_route). Returns a fresh (P, T, S) int32 CPU tensor."""
    if rk.device.type != "cpu":
        raise ValueError(f"round keys on {rk.device}: the host tier takes "
                         "CPU tensors")
    out = np.empty((rk.shape[0], T, S), np.uint32)
    for p, keys in enumerate(rk.numpy()):
        out[p] = native_lib.prf_offset_table(keys, 0, T, S, chunk_mask)
    return torch.from_numpy(out.view(np.int32))
