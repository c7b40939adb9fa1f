"""Device-side database layout for PIR kernels.

The reference stores the DB as a flat []uint64 indexed by entry
(pianopir/pir.go:28-31,60,80). The hot access pattern is "gather rows
by offset per chunk, XOR" (pir.go:281-300 hints at chunk streaming), so the
DB is laid out chunk-major with 128-word rows — the JAX package's padded
layout, kept so the two packages' states compare bit for bit:

    db_dev: (SetSize, ChunkSize * k, 128) uint32,  k = ceil(entry_u32 / 128)

Each entry occupies k consecutive 128-lane rows (zero-padded), so a gather by
offset is k perfectly aligned row reads — no unaligned lane slicing. Entries
past DBSize are zero rows; XOR with zero is a no-op, which reproduces the
server's skip of out-of-range padded indices (pir.go:75-77).
"""

import dataclasses

import numpy as np


def entry_rows(entry_u32: int) -> int:
    return (entry_u32 + 127) // 128


@dataclasses.dataclass(frozen=True)
class DbLayout:
    db_size: int
    entry_u32: int
    chunk_size: int
    set_size: int

    @property
    def k(self) -> int:
        return entry_rows(self.entry_u32)

    @property
    def padded_entry_u32(self) -> int:
        return self.k * 128

    @property
    def shape(self):
        return (self.set_size, self.chunk_size * self.k, 128)


def pack_db(raw: np.ndarray, chunk_size: int, set_size: int) -> np.ndarray:
    """raw: (db_size, entry_u32) u32 -> (set_size, chunk_size*k, 128) u32."""
    n, e = raw.shape
    k = entry_rows(e)
    total = set_size * chunk_size
    out = np.zeros((total, k * 128), dtype=np.uint32)
    out[:n, :e] = raw
    return out.reshape(set_size, chunk_size * k, 128)


def unpack_entries(padded: np.ndarray, entry_u32: int) -> np.ndarray:
    """(..., k, 128) or (..., k*128) u32 -> (..., entry_u32) u32."""
    if padded.shape[-1] == 128:  # collapse the (k, 128) row pair
        padded = padded.reshape(padded.shape[:-2] + (-1,))
    return padded[..., :entry_u32]
