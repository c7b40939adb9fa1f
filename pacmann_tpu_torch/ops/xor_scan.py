"""Gather-XOR parity scans over the chunk-major PIR database.

One contract serves the reference protocol's two XOR hot loops, both on the
JAX package's padded (S, P, C*k, 128) layout (pir/layout.py):
  - offline hint generation (pir.go:303-352; the JAX package's
    xor_hintgen_mm / xor_scan_parts): (P, T, S) offsets + skip -> (P, T, Ep);
  - the online server scan (pir.go:65-88; xor_server_scan /
    xor_gather_multi): (Q, P, S) offsets -> (Q, P, k, 128).

    out[p, b] = XOR_s db4[s, p, off[p, b, s]*k : +k, :]   (skip -> 0)

An offset outside [0, C) is a skip. Two versions of that function:
  - xor_gather_plain: a loop over s of torch gathers (torch has no XOR
    reduction);
  - xor_gather_cuda: kernel K2 (csrc/xor_gather.cu), one warp per row of
    the output and group of at most 4 of its 128-word rows; any k >= 1.
xor_gather routes a CPU tensor to the plain version and a CUDA tensor to
the kernel; there is no fallback between them.
"""

from __future__ import annotations

import ctypes

import torch

from pacmann_tpu_torch.utils import cuda_lib

SKIP = -1   # the sentinel offset hint generation writes for a skipped chunk


def xor_gather_plain(db4: torch.Tensor, offsets: torch.Tensor,
                     k: int) -> torch.Tensor:
    """Plain torch version: db4 (S, P, C*k, 128) int32, offsets (P, B, S)
    int32 -> (P, B, k*128) int32."""
    S, P, CK, L = db4.shape
    C = CK // k
    B = offsets.shape[1]
    acc = torch.zeros((P, B, k, L), dtype=db4.dtype, device=db4.device)
    p_ix = torch.arange(P, device=db4.device)[:, None, None]
    r_ix = torch.arange(k, device=db4.device)
    for s in range(S):
        off = offsets[:, :, s]
        live = (off >= 0) & (off < C)
        rows = torch.where(live, off, 0).long()[:, :, None] * k + r_ix
        g = db4[s][p_ix, rows]                           # (P, B, k, L)
        acc ^= torch.where(live[:, :, None, None], g, 0)
    return acc.reshape(P, B, k * L)


def xor_gather_cuda(db4: torch.Tensor, offsets: torch.Tensor,
                    k: int) -> torch.Tensor:
    """Kernel K2: same contract as xor_gather_plain, on CUDA tensors.
    Counts its launches in xor_gather_cuda.launches."""
    cuda_lib.require_cuda_tensor(db4, "db4", torch.int32)
    cuda_lib.require_cuda_tensor(offsets, "offsets", torch.int32)
    S, P, CK, L = db4.shape
    if L != 128 or k < 1 or CK % k:
        raise ValueError(f"db4 {tuple(db4.shape)} with k={k} is not a "
                         "(S, P, C*k, 128) layout with k >= 1")
    if offsets.device != db4.device or offsets.dim() != 3 \
            or offsets.shape[0] != P or offsets.shape[2] != S:
        raise ValueError(f"offsets {tuple(offsets.shape)} do not match "
                         f"db4 {tuple(db4.shape)}")
    B = offsets.shape[1]
    out = torch.empty((P, B, k * L), dtype=torch.int32, device=db4.device)
    fn = cuda_lib.function("xor_gather", "xor_gather", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p])
    cuda_lib.check(
        fn(db4.data_ptr(), offsets.data_ptr(), out.data_ptr(), S, P,
           CK // k, k, B, cuda_lib.stream_ptr(db4.device)), "xor_gather")
    xor_gather_cuda.launches += 1
    return out


xor_gather_cuda.launches = 0


def xor_gather(db4: torch.Tensor, offsets: torch.Tensor,
               k: int) -> torch.Tensor:
    """(S, P, C*k, 128) DB, (P, B, S) offsets -> (P, B, k*128) parities:
    the plain version for a CPU tensor, kernel K2 for a CUDA tensor."""
    if db4.device.type == "cpu":
        return xor_gather_plain(db4, offsets, k)
    return xor_gather_cuda(db4, offsets, k)


def xor_hintgen(db4: torch.Tensor, table: torch.Tensor, skip: torch.Tensor,
                k: int) -> torch.Tensor:
    """Hint generation: table (P, T, S) int32 offsets, skip (P, T, S) bool
    -> (P, T, k*128) parities (the JAX package's xor_hintgen_mm contract)."""
    off = torch.where(skip, SKIP, table).to(torch.int32)
    return xor_gather(db4, off.contiguous(), k)


def xor_server_scan(db4: torch.Tensor, qs: torch.Tensor,
                    k: int) -> torch.Tensor:
    """The server's online batch scan: qs (Q, P, S) int32 offset vectors ->
    (Q, P, k, 128) parities (the JAX package's xor_server_scan)."""
    Q, P, S = qs.shape
    out = xor_gather(db4, qs.transpose(0, 1).contiguous(), k)   # (P, Q, Ep)
    return out.transpose(0, 1).reshape(Q, P, k, 128)
