"""Carry PIR state between the JAX package and the port.

The JAX engine's state (after jax.device_get) is a dict of numpy arrays:
u32 parities, program points and replacement indices, u16 (or u32) offset
tables and slot columns, int32 tags and counters. The port holds every one
of them as an int32 tensor with the same value bits (utils/u32.py).
"""

from __future__ import annotations

import numpy as np
import torch

from pacmann_tpu_torch.pir.device_engine import STATE_KEYS
from pacmann_tpu_torch.utils.u32 import from_u32, to_u32


def _to_tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.itemsize == 4 and a.dtype.kind in "iu":
        return from_u32(a, device)
    if a.dtype in (np.uint16, np.int16, np.uint8):
        return torch.from_numpy(a.astype(np.int32)).to(device)
    raise TypeError(f"unsupported state dtype {a.dtype}")


def state_from_numpy(state: dict[str, np.ndarray], device) -> dict:
    """A JAX engine's state -> the port's state on `device`. Only the
    table engine's state converts (a table-free state has no offsets)."""
    missing = [k for k in STATE_KEYS if k not in state]
    if missing:
        raise ValueError(f"state lacks {missing} (table-free state?)")
    return {k: _to_tensor(state[k], device) for k in STATE_KEYS}


def db_from_numpy(db: np.ndarray, device) -> torch.Tensor:
    """The JAX engine's packed (S, P, C*k, 128) u32 DB -> int32 tensor."""
    return from_u32(np.asarray(db, np.uint32), device)


def state_to_numpy(state: dict) -> dict[str, np.ndarray]:
    """The port's state -> u32 numpy arrays (same bits), for comparison."""
    return {k: to_u32(v) for k, v in state.items()}
