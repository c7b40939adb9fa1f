"""Vector / graph file I/O: bvecs, fvecs, ivecs, npy, txt.

Port of the reference's graphann/loader.go (C11 in SURVEY.md §2) with the same
format dispatch by extension (loader.go:197-215, 287-300) and the same
contracts (bvecs bytes -> float32, npy float64 -> float32, graph saved as
int32 npy or whitespace txt). The per-vector Go decode loops are replaced by
single vectorized NumPy reshapes over the raw byte buffer — one allocation,
no per-row parsing.

*.vecs layout (TEXMEX/bigann): each vector is a 4-byte little-endian int32
dimension header followed by dim elements (u8 for bvecs, f32 for fvecs,
i32 for ivecs).
"""

from __future__ import annotations

import os

import numpy as np


def _vecs_raw(path: str, n: int, dim: int, elem_dtype, elem_size: int):
    """Memory-map a .?vecs file and return the (n, dim) element block."""
    row_bytes = 4 + dim * elem_size
    need = n * row_bytes
    size = os.path.getsize(path)
    if size < need:
        raise ValueError(
            f"{path}: need {need} bytes for n={n} dim={dim}, file has {size}"
        )
    raw = np.memmap(path, dtype=np.uint8, mode="r", shape=(n, row_bytes))
    hdr = raw[:, :4].view("<i4").reshape(n)
    if not np.all(hdr == dim):
        bad = int(np.flatnonzero(hdr != dim)[0])
        raise ValueError(
            f"{path}: vector {bad} has dim header {int(hdr[bad])}, expected {dim}"
        )
    return np.ascontiguousarray(raw[:, 4:]).view(elem_dtype).reshape(n, dim)


def load_bvecs(path: str, n: int, dim: int, *,
               keep_bytes: bool = False) -> np.ndarray:
    """(n, dim) float32 from byte vectors (loader.go:16-58).

    keep_bytes=True returns the raw uint8 matrix instead, a quarter of the
    float form's size, for a caller that widens it to f32 itself (u8 -> f32
    is exact)."""
    b = _vecs_raw(path, n, dim, "<u1", 1)
    return b if keep_bytes else b.astype(np.float32)


def load_fvecs(path: str, n: int, dim: int) -> np.ndarray:
    """(n, dim) float32 (loader.go:64-85)."""
    return _vecs_raw(path, n, dim, "<f4", 4).astype(np.float32, copy=False)


def load_ivecs(path: str, n: int, dim: int) -> np.ndarray:
    """(n, dim) int32 (loader.go:91-116)."""
    return _vecs_raw(path, n, dim, "<i4", 4).astype(np.int32, copy=False)


def load_npy_f32(path: str, n: int, dim: int) -> np.ndarray:
    """float32 matrix from .npy; reference stores float64 (loader.go:163-195)."""
    a = np.load(path)
    a = np.asarray(a, dtype=np.float32).reshape(n, dim)
    return a


def load_npy_i32(path: str, n: int, m: int) -> np.ndarray:
    a = np.load(path)
    return np.asarray(a, dtype=np.int32).reshape(n, m)


def load_txt_matrix(path: str, n: int, dim: int, dtype) -> np.ndarray:
    """Whitespace-separated matrix (loader.go:122-157, 250-285)."""
    a = np.loadtxt(path, dtype=dtype, ndmin=2)
    if a.shape[0] < n:
        raise ValueError(f"{path}: only {a.shape[0]} rows, need {n}")
    return np.ascontiguousarray(a[:n, :dim])


def load_float32_matrix(path: str, n: int, dim: int) -> np.ndarray:
    """Extension dispatch (loader.go:197-215)."""
    ext = os.path.splitext(path)[1]
    if ext == ".bvecs":
        return load_bvecs(path, n, dim)
    if ext == ".fvecs":
        return load_fvecs(path, n, dim)
    if ext == ".npy":
        return load_npy_f32(path, n, dim)
    if ext == ".txt":
        return load_txt_matrix(path, n, dim, np.float32)
    raise ValueError(f"unknown vector file extension: {ext}")


def load_int_matrix(path: str, n: int, m: int) -> np.ndarray:
    """Graph / ground-truth loader dispatch (loader.go:287-300)."""
    ext = os.path.splitext(path)[1]
    if ext == ".npy":
        return load_npy_i32(path, n, m)
    if ext == ".txt":
        return load_txt_matrix(path, n, m, np.int64).astype(np.int32)
    if ext == ".ivecs":
        return load_ivecs(path, n, m)
    raise ValueError(f"unknown graph file extension: {ext}")


def save_int_matrix(path: str, mat: np.ndarray) -> None:
    """Save graph/answers as int32 npy or txt (loader.go:306-347)."""
    mat = np.asarray(mat)
    ext = os.path.splitext(path)[1]
    if ext == ".npy":
        np.save(path, mat.astype(np.int32))
        # np.save appends .npy if missing; path already ends with it
        return
    if ext == ".txt":
        with open(path, "w") as f:
            for row in mat:
                f.write(" ".join(str(int(x)) for x in row) + " \n")
        return
    raise ValueError(f"unknown save extension: {ext}")



# Aliases mirroring the reference's names (loader.go:197,301,306).
LoadFloat32Matrix = load_float32_matrix
LoadIntMatrixFromFile = load_int_matrix
SaveIntMatrixToFile = save_int_matrix
