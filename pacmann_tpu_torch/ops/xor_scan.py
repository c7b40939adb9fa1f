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
  - xor_gather_cuda: kernel K2 (csrc/xor_gather.cu), any k >= 1, in one
    of three forms that gather_form picks by shape. Hint generation,
    where a partition's B rows name each chunk row many times, takes
    "chunk" (chunk-major: a chunk's rows staged in shared memory, read by
    a block of up to 2,560 hints) at C <= 512 and "sliced" (a CTA gathers
    one 128-byte column slice of the entries for its hints, so that the
    hints resident together share each chunk's slice in L2) above; the
    rest "row" (row-split: row_split_warps warps per output row and group
    of at most 4 of its 128-word rows, their partial sums XORed in shared
    memory).
xor_gather routes a CPU tensor to the plain version and a CUDA tensor to
the kernel; there is no fallback between them, nor between the forms.

xor_scan_native is the host tier's scan on the flat (S, C*k, 128) layout,
which the engines take on the CPU where native_lib is available (the JAX
package's xor_scan_host); elsewhere they call their kernel's dispatcher.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from pacmann_tpu_torch import native_lib
from pacmann_tpu_torch.utils import cuda_lib, trace

SKIP = -1   # the sentinel offset hint generation writes for a skipped chunk

# The chunk-major form reads a chunk's whole slice once per block of hints,
# the row form only the rows its offsets name. On the H100 the first is
# the faster at hint generation (B = 24C) and at B = 16C, the second at
# the server scan (B <= 96) and on a short scan (S = 13, B ~ 10C). Its
# ring of 2 x (C + 1) rows of 64 B and the run tables must fit the card's
# shared memory: 188,544 B at C = 512 (the kernel refuses C above 855).
CHUNK_MAJOR_MIN_REUSE = 16
CHUNK_MAJOR_MAX_C = 512
# Above that C the sliced form gathers each 128-byte slice of a named row
# from L2, where the hints resident together fetched it: on the H100 at
# uniform offsets it is 3-18 % faster than the row form at B = C, 33-34 %
# at 2C and 36-50 % at 4C (C = 8,192 and 1,024).
SLICED_MIN_REUSE = 2
# warps that fill an H100 at half occupancy (132 SMs x 32): the row form
# splits rows over more warps until it has as many
ROW_SPLIT_TARGET_WARPS = 132 * 32
ROW_SPLIT_MAX_WARPS = 8         # warps a row: one block of 256 threads
STAGED_CHUNKS = 8               # chunks a warp stages per step


def group_rows(k: int) -> int:
    """Rows of an entry one warp of the row form owns (csrc/xor_gather.cu
    group_rows): the whole entry up to 4 rows, else the largest of 4, 3,
    2 that divides k, else 1."""
    if k <= 4:
        return k
    return next((g for g in (4, 3, 2) if k % g == 0), 1)


def gather_form(P: int, B: int, S: int, C: int, k: int) -> str:
    """K2's form for a (P, B) output over S chunks of C entries of k rows:
    "chunk" where B >= CHUNK_MAJOR_MIN_REUSE * C and C <=
    CHUNK_MAJOR_MAX_C, "sliced" where B >= SLICED_MIN_REUSE * C and C >
    CHUNK_MAJOR_MAX_C, else "row". Deterministic, and no fallback: the
    form chosen launches or raises."""
    if C <= CHUNK_MAJOR_MAX_C:
        return "chunk" if B >= CHUNK_MAJOR_MIN_REUSE * C else "row"
    return "sliced" if B >= SLICED_MIN_REUSE * C else "row"


def row_split_warps(P: int, B: int, S: int, k: int) -> int:
    """Warps per output row of the row form: doubled from 1 while the
    launch has fewer than ROW_SPLIT_TARGET_WARPS warps, up to
    ROW_SPLIT_MAX_WARPS and to one staging step of chunks a warp."""
    tasks = P * B * (k // group_rows(k))
    steps = -(-S // STAGED_CHUNKS)
    W = 1
    while (W < ROW_SPLIT_MAX_WARPS and 2 * W <= steps
           and tasks * W < ROW_SPLIT_TARGET_WARPS):
        W *= 2
    return W


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


def xor_gather_cuda(db4: torch.Tensor, offsets: torch.Tensor, k: int,
                    form: str | None = None) -> torch.Tensor:
    """Kernel K2: same contract as xor_gather_plain, on CUDA tensors, in
    `form` ("chunk", "sliced" or "row"; None: gather_form's choice; the
    row form takes row_split_warps warps a row). Counts its launches in
    xor_gather_cuda.launches, and those of the sliced form in the trace
    counter "k2.sliced"."""
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
    B, C = offsets.shape[1], CK // k
    form = form or gather_form(P, B, S, C, k)
    out = torch.empty((P, B, k * L), dtype=torch.int32, device=db4.device)
    argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
    args = [db4.data_ptr(), offsets.data_ptr(), out.data_ptr(), S, P, C, k,
            B]
    if form in ("chunk", "sliced"):
        entry = "xor_gather_chunk_major" if form == "chunk" \
            else "xor_gather_sliced"
        fn = cuda_lib.function("xor_gather", entry,
                               argtypes + [ctypes.c_void_p])
    elif form == "row":
        fn = cuda_lib.function("xor_gather", "xor_gather_row_split",
                               argtypes + [ctypes.c_int, ctypes.c_void_p])
        args.append(row_split_warps(P, B, S, k))
    else:
        raise ValueError(f"unknown K2 form {form!r}")
    cuda_lib.check(fn(*args, cuda_lib.stream_ptr(db4.device)),
                   f"xor_gather ({form})")
    xor_gather_cuda.launches += 1
    if form == "sliced":
        trace.count("k2.sliced")
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


def _host_array(x) -> np.ndarray:
    """x, a tensor or a numpy array, as a read-only numpy array on the
    host (a view where x is a contiguous CPU tensor or an array): the host
    kernel reads live engine state in place and writes none of it."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().contiguous().numpy()
    a = np.asarray(x).view()
    a.flags.writeable = False
    return a


def xor_scan_native(db: torch.Tensor, offsets: torch.Tensor,
                    skip: torch.Tensor, k: int) -> torch.Tensor:
    """The scan on the flat (S, C*k, 128) int32 layout through the host
    tier, native_lib.xor_scan (the caller checks native_lib.host_route):
    db a CPU tensor, offsets (B, S) u32 (outside [0, C): a skip) and skip
    (B, S) bool, tensors or numpy arrays -> a fresh (B, k, 128) int32 CPU
    tensor."""
    if db.device.type != "cpu":
        raise ValueError(f"db on {db.device}: the host tier takes CPU "
                         "tensors")
    out = native_lib.xor_scan(_host_array(db), _host_array(offsets),
                              _host_array(skip), k)
    return torch.from_numpy(out.view(np.int32))
