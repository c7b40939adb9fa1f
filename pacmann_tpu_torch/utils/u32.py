"""u32 data in torch, and the tie order the JAX reference relies on.

torch has no usable uint32 (no shifts, %, //, gather, index_put or
comparisons), so every u32 array of the protocol — DB words, parities,
program points, offsets — is held as an int32 tensor with the same bits.
XOR, equality and gathers are bit-exact on that view; every index the
protocol compares or orders (offsets, chunk ids, the 0x7FFFFFFF default
program point) is below 2^31, so ordering on the view is exact too.
"""

from __future__ import annotations

import numpy as np
import torch


def from_u32(a, device=None) -> torch.Tensor:
    """u32 (or any 4-byte int) numpy array -> int32 tensor, same bits. The
    tensor owns a copy: state tensors are updated in place, and the array
    may be read-only or another framework's buffer."""
    a = np.ascontiguousarray(a)
    if a.dtype.itemsize != 4 or a.dtype.kind not in "iu":
        raise TypeError(f"expected a 4-byte integer array, got {a.dtype}")
    return torch.tensor(a.view(np.int32), device=device)


def u32_view(a) -> torch.Tensor:
    """u32 (or any 4-byte int) numpy array -> int32 CPU tensor, same bits,
    sharing the array's memory (a copy where the array is read-only): for
    a large input read once, such as raw DB rows about to be packed."""
    a = np.ascontiguousarray(a)
    if a.dtype.itemsize != 4 or a.dtype.kind not in "iu":
        raise TypeError(f"expected a 4-byte integer array, got {a.dtype}")
    if not a.flags.writeable:
        a = a.copy()
    return torch.from_numpy(a.view(np.int32))


def to_u32(t: torch.Tensor) -> np.ndarray:
    """int32 tensor -> u32 numpy array, same bits, never sharing memory
    with the tensor (which may be state that is updated in place)."""
    if t.dtype != torch.int32:
        raise TypeError(f"expected int32, got {t.dtype}")
    return t.detach().to("cpu", copy=True).numpy().view(np.uint32)


def as_f32(t: torch.Tensor) -> torch.Tensor:
    """Reinterpret int32 words as float32 (jax.lax.bitcast_convert_type)."""
    return t.contiguous().view(torch.float32)


def smallest_k(x: torch.Tensor, k: int):
    """(values, indices) of the k smallest entries along the last axis,
    equal values in ascending index order.

    The twin of jax.lax.top_k(-x, k), which breaks ties by the lower index;
    torch.topk gives no order among ties, so a stable sort stands in."""
    vals, idx = torch.sort(x, dim=-1, stable=True)
    return vals[..., :k], idx[..., :k]


def smallest_k_keyed(vals: torch.Tensor, ids: torch.Tensor, k: int):
    """(values, ids) of the k smallest (value, id) pairs along the last
    axis, by value and then by the lower id: smallest_k's order where the
    ids are column indices, without sorting whole rows. For non-negative
    float32 values (distances) and ids in [0, 2^32): one top-k over int64
    keys (value bits << 32 | id), which are unique and order like the
    pairs."""
    key = (vals.contiguous().view(torch.int32).to(torch.int64) << 32) \
        | ids.to(torch.int64)
    key = torch.topk(key, k, dim=-1, largest=False, sorted=True).values
    return (key >> 32).to(torch.int32).view(torch.float32), key & 0xFFFFFFFF


def first_true(mask: torch.Tensor, dim: int) -> torch.Tensor:
    """Index of the first True along dim (0 where none), like jnp.argmax on
    bool; torch.argmax takes no bool and returns the first maximum."""
    return torch.argmax(mask.to(torch.uint8), dim=dim)
