"""Carry PIR state between the JAX package and the port.

The JAX engine's state (after jax.device_get) is a dict of numpy arrays:
u32 parities, program points and replacement indices, u16 (or u32) offset
tables and slot columns, int32 tags and counters. The port holds every one
of them as an int32 tensor with the same value bits (utils/u32.py). A
table-free JAX state holds the partitions' AES round keys as bit-plane
masks (P, 11, 8, 16) in place of the table; the port holds the same keys
as bytes, "rk" (P, 11, 16) uint8. A sharded JAX engine's state reads as
the same global arrays (np.asarray gathers them); load_state splits it by
shard for the port's ShardedPianoEngine.
"""

from __future__ import annotations

import numpy as np
import torch

from pacmann_tpu_torch.pir.device_engine import (
    STATE_KEYS, TABLE_FREE_STATE_KEYS)
from pacmann_tpu_torch.pir.sharded_engine import ShardedPianoEngine
from pacmann_tpu_torch.utils.u32 import from_u32, to_u32


def _to_tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.itemsize == 4 and a.dtype.kind in "iu":
        return from_u32(a, device)
    if a.dtype in (np.uint16, np.int16, np.uint8):
        return torch.from_numpy(a.astype(np.int32)).to(device)
    raise TypeError(f"unsupported state dtype {a.dtype}")


def rk_from_masks(masks: np.ndarray) -> np.ndarray:
    """(P, 11, 8, 16) round-key bit-plane masks (0 or all ones) -> the
    (P, 11, 16) uint8 round keys: bit b of key byte j is masks[.., b, j] & 1."""
    bits = (np.asarray(masks) & 1).astype(np.uint8)
    shifts = np.arange(8, dtype=np.uint8)[None, None, :, None]
    return np.bitwise_or.reduce(bits << shifts, axis=2)


def state_from_numpy(state: dict[str, np.ndarray], device,
                     partitions: tuple[int, int] | None = None) -> dict:
    """A JAX engine's state, with its table or (table-free) its masks ->
    the port's state on `device` (STATE_KEYS or TABLE_FREE_STATE_KEYS).
    partitions = (lo, hi) converts only those partitions (axis 0 of every
    leaf)."""
    if partitions is not None:
        state = {k: np.asarray(v)[partitions[0]:partitions[1]]
                 for k, v in state.items()}
    table_free = "masks" in state
    keys = TABLE_FREE_STATE_KEYS if table_free else STATE_KEYS
    want = [k for k in keys if k != "rk"] + (["masks"] if table_free else [])
    missing = [k for k in want if k not in state]
    if missing:
        raise ValueError(f"state lacks {missing}")
    out = {k: _to_tensor(state[k], device) for k in keys if k != "rk"}
    if table_free:
        out["rk"] = torch.from_numpy(rk_from_masks(state["masks"])).to(device)
    return out


def load_state(engine, state: dict[str, np.ndarray]) -> None:
    """Install a JAX engine's state (global numpy arrays) in a port engine:
    a ShardedPianoEngine takes each shard's partitions on that shard's
    device, and no device receives more than its shard; any other engine
    takes the whole state on its device."""
    if isinstance(engine, ShardedPianoEngine):
        engine.shard_states = [
            state_from_numpy(state, dev, rng) for rng, dev in
            zip(engine.partition_ranges, engine.mesh.devices)]
    else:
        engine.state = state_from_numpy(state, engine.device)


def db_from_numpy(db: np.ndarray, device) -> torch.Tensor:
    """The JAX engine's packed (S, P, C*k, 128) u32 DB -> int32 tensor."""
    return from_u32(np.asarray(db, np.uint32), device)


def state_to_numpy(state: dict) -> dict[str, np.ndarray]:
    """The port's state -> u32 numpy arrays (same bits), and the round keys
    of a table-free state as uint8, for comparison. Copies, never views."""
    return {k: to_u32(v) if v.dtype == torch.int32
            else v.detach().to("cpu", copy=True).numpy()
            for k, v in state.items()}
