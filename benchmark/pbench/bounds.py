"""The least time the card could take for a piece of work: frozen copies of
chip_smoke.py's `bound` and `gather_bound`, and the least time of a whole
hint generation.

Peak rates of one H100 SXM (NVIDIA's data sheet: 132 SMs, 1.98 GHz boost
clock, HBM3 at 3.35 TB/s), at its full 700 W power limit. Bytes count each
input read once and each output written once, whatever a kernel reads
again.
"""

from __future__ import annotations

import torch

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
SMEM_LOOKUPS_PER_S = 132 * 32 * 1.98e9
FP32_FLOPS_PER_S = 132 * 128 * 2 * 1.98e9

# kernel K2's device functions in csrc/xor_gather.cu, both forms (the
# chunk-major `staged_kernel` and the row-split `row_split_kernel`)
K2_KERNELS = r"staged_kernel|row_split_kernel"


def bound(nbytes: float, int_ops: float = 0.0, lookups: float = 0.0,
          flops: float = 0.0) -> dict:
    """The larger of the bytes moved over the HBM rate and the operations
    over their peak rate, in ms, and which of the two bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(int_ops / INT32_OPS_PER_S, lookups / SMEM_LOOKUPS_PER_S,
                flops / FP32_FLOPS_PER_S)
    return dict(bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bound_bytes=nbytes, bound_int_ops=int_ops,
                bound_lookups=lookups, bound_flops=flops)


def live_keys(off: torch.Tensor, skip, C: int) -> torch.Tensor:
    """The (s * P + p) * C + offset key of every live offset of a (P, B, S)
    offset tensor (outside [0, C), or under `skip`, is not live)."""
    P, B, S = off.shape
    live = (off >= 0) & (off < C)
    if skip is not None:
        live &= ~skip
    p_ix = torch.arange(P, device=off.device)[:, None, None]
    s_ix = torch.arange(S, device=off.device)
    return ((s_ix * P + p_ix) * C + off.long())[live]


def gather_bound(off: torch.Tensor, skip, C: int, k: int) -> tuple[dict,
                                                                     int]:
    """The bound of a gather-XOR over (P, B, S) offsets (skip: a mask beside
    them, or None): the distinct DB entries the live offsets name, read
    once (k rows of 512 B), the offsets and the mask read once, the
    (P, B, k*128) parities written once, and one XOR per gathered word.
    Also returns the count of distinct entries."""
    P, B, S = off.shape
    keys = live_keys(off, skip, C)
    rows = torch.unique(keys).numel()
    mask_bytes = 0 if skip is None else skip.numel()
    return bound(rows * k * 512 + off.numel() * 4 + mask_bytes
                 + P * B * k * 512, int_ops=keys.numel() * k * 128), rows


def named_user_rows(off: torch.Tensor, skip, C: int, psize: int,
                    n: int) -> int:
    """How many of the DB's real rows the live offsets name: entry
    (p, s, offset) is row p * psize + s * C + offset, real where its
    partition-local index is below psize and the row below n."""
    P, _, S = off.shape
    keys = torch.unique(live_keys(off, skip, C))
    p = keys // C % P
    local = keys // (C * P) * C + keys % C
    return int(((local < psize) & (p * psize + local < n)).sum())


def prep_bound(off: torch.Tensor, skip, state: dict, *, C: int, psize: int,
               n: int, entry_bytes: int) -> dict:
    """The least time of one hint generation: the user bytes of the rows
    its hints name (entry_bytes a row), read once, and the bytes of the
    state it leaves, written once, at the HBM rate."""
    named = named_user_rows(off, skip, C, psize, n)
    state_bytes = sum(v.numel() * v.element_size() for v in state.values())
    return dict(bound(named * entry_bytes + state_bytes),
                named_rows=named, state_bytes=state_bytes)
