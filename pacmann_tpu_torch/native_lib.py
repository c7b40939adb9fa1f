"""ctypes loader for the host tier's C++ kernels
(csrc/host/pacmann_native.cpp): the port of the JAX package's
native_lib.py, with its names and contracts, numpy in and numpy out.

The library is compiled on first use with the host's C++ compiler
(utils/cuda_lib.py::load_host: g++ -O3 -maes -mavx2 -mfma into
pacmann_tpu_torch/build/, named by a hash of the source); a machine with
no compiler, or a CPU without AES-NI, AVX2 and FMA, gets no library, and
available() is False. The kernels cover the host side only, the hot
spots of the reference's assembly (pianopir/aes_amd64.s,
graphann/l2_distance_amd64.s): the engines take them where they run on
the CPU (pir/device_engine.py, pir/piano.py, pir/engine.py, through
aes.prf_tables_native and xor_scan.xor_scan_native, where host_route says
so), and take the plain torch versions where available() is False. A
CUDA engine never calls them.

Each entry point counts its calls in `<entry point>.calls` (reset_calls()
sets them to 0), as the kernel wrappers count launches, so a caller can
see which route ran.
"""

from __future__ import annotations

import ctypes

import numpy as np

from pacmann_tpu_torch.utils import cuda_lib

_lib = None
_load_failed = False


def load():
    """Return the ctypes library or None (after one build attempt)."""
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    try:
        lib = cuda_lib.load_host("pacmann_native")
    except (RuntimeError, OSError):
        _load_failed = True
        return None

    # Refuse CPUs without AES-NI/AVX2/FMA: the kernels would SIGILL.
    lib.pacmann_cpu_supported.argtypes = []
    lib.pacmann_cpu_supported.restype = ctypes.c_int
    if not lib.pacmann_cpu_supported():
        _load_failed = True
        return None

    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
    u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i64 = ctypes.c_int64

    for name, argtypes in (
            ("pacmann_expand_key", [u8p, u8p]),
            ("pacmann_prf_eval_u64", [u8p, u64p, u64p, u64p, i64]),
            ("pacmann_prf_offset_table", [u8p, ctypes.c_uint64, i64, i64,
                                          ctypes.c_uint32, u32p]),
            ("pacmann_xor_scan", [u32p, u32p, u8p, u32p, i64, i64, i64, i64]),
            ("pacmann_l2_batch", [f32p, f32p, f32p, i64, i64, i64]),
            ("pacmann_inner_product_u32", [u32p, u32p, u32p, i64, i64, i64])):
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = None
    _lib = lib
    return _lib


def available() -> bool:
    return load() is not None


def host_route(device) -> bool:
    """Whether a pass of an engine on `device` (a torch.device or its
    name) takes the host tier: a CPU device and the library available."""
    return str(getattr(device, "type", device)).split(":")[0] == "cpu" \
        and available()


# ---------------------------------------------------------------------------
# Wrappers (raise RuntimeError when the library is missing; callers that have
# a plain version check available() or host_route() first).


def _require():
    lib = load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    return lib


def _u32(a) -> np.ndarray:
    """a as a C-contiguous u32 array: any contiguous 4-byte integer array
    is viewed bit for bit (no copy of a DB), anything else converted."""
    a = np.asarray(a)
    if a.dtype.kind in "iu" and a.dtype.itemsize == 4 \
            and a.flags.c_contiguous:
        return a.view(np.uint32)
    return np.ascontiguousarray(a, np.uint32)


def _round_keys(rk176) -> np.ndarray:
    rk = np.ascontiguousarray(rk176, np.uint8).reshape(-1)
    if rk.size != 176:
        raise ValueError(f"round keys must be 176 bytes, got {rk.size}")
    return rk


def expand_key(key: bytes) -> np.ndarray:
    """AES-128 key schedule -> (176,) u8 round keys."""
    lib = _require()
    if len(key) != 16:
        raise ValueError(f"an AES-128 key is 16 bytes, got {len(key)}")
    rk = np.empty(176, np.uint8)
    lib.pacmann_expand_key(np.frombuffer(key, np.uint8).copy(), rk)
    expand_key.calls += 1
    return rk


def prf_eval_u64(rk176: np.ndarray, tags: np.ndarray,
                 xs: np.ndarray) -> np.ndarray:
    """PRF(tag, x) as full u64 (the caller masks), tags and xs broadcast."""
    lib = _require()
    tags, xs = np.broadcast_arrays(np.asarray(tags, np.uint64),
                                   np.asarray(xs, np.uint64))
    flat_t = np.ascontiguousarray(tags.reshape(-1))
    flat_x = np.ascontiguousarray(xs.reshape(-1))
    out = np.empty(flat_t.shape[0], np.uint64)
    lib.pacmann_prf_eval_u64(_round_keys(rk176), flat_t, flat_x, out,
                             flat_t.shape[0])
    prf_eval_u64.calls += 1
    return out.reshape(tags.shape)


def prf_offset_table(rk176: np.ndarray, tag0: int, T: int, S: int,
                     mask: int) -> np.ndarray:
    """(T, S) u32: PRF(tag0+t, s) & mask — the hint-gen offset table."""
    lib = _require()
    if T < 0 or S < 0 or not 0 <= mask < 1 << 32:
        raise ValueError(f"bad table (T={T}, S={S}, mask={mask})")
    out = np.empty((T, S), np.uint32)
    lib.pacmann_prf_offset_table(_round_keys(rk176), tag0, T, S, mask, out)
    prf_offset_table.calls += 1
    return out


def xor_scan(db: np.ndarray, offsets: np.ndarray, skip: np.ndarray,
             k: int) -> np.ndarray:
    """The JAX package's xor_scan_np contract: db (S, CK, 128) u32 (a
    4-byte integer array is read in place), offsets / skip (B, S) ->
    (B, k, 128) u32, a fresh array. An offset outside [0, CK/k) reads
    nothing, as a skip (the kernel does not check bounds)."""
    lib = _require()
    db = _u32(db)
    S, CK, L = db.shape
    offsets = _u32(offsets)
    if L != 128 or k < 1 or CK % k or offsets.ndim != 2 \
            or offsets.shape[1] != S or np.shape(skip) != offsets.shape:
        raise ValueError(f"db {db.shape}, offsets {offsets.shape}, skip "
                         f"{np.shape(skip)}, k={k}: not an (S, C*k, 128) "
                         "DB with (B, S) offsets and skip")
    B = offsets.shape[0]
    skip8 = (np.asarray(skip, bool) | (offsets >= CK // k)).astype(np.uint8)
    out = np.empty((B, k * 128), np.uint32)
    lib.pacmann_xor_scan(db, offsets, skip8, out, B, S, CK, k)
    xor_scan.calls += 1
    return out.reshape(B, k, 128)


def l2_batch(queries: np.ndarray, points: np.ndarray) -> np.ndarray:
    """(nq, d), (nb, d) -> (nq, nb) f32 squared L2 distances."""
    lib = _require()
    queries = np.ascontiguousarray(queries, np.float32)
    points = np.ascontiguousarray(points, np.float32)
    if queries.ndim != 2 or points.ndim != 2 \
            or queries.shape[1] != points.shape[1]:
        raise ValueError(f"queries {queries.shape}, points {points.shape}")
    out = np.empty((queries.shape[0], points.shape[0]), np.float32)
    lib.pacmann_l2_batch(queries, points, out,
                         queries.shape[0], points.shape[0], queries.shape[1])
    l2_batch.calls += 1
    return out


def inner_product_u32(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(nq, d), (nb, d) u32 -> (nq, nb) u32 dot products, wrapping."""
    lib = _require()
    a = np.ascontiguousarray(a, np.uint32)
    b = np.ascontiguousarray(b, np.uint32)
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[1]:
        raise ValueError(f"a {a.shape}, b {b.shape}")
    out = np.empty((a.shape[0], b.shape[0]), np.uint32)
    lib.pacmann_inner_product_u32(a, b, out, a.shape[0], b.shape[0],
                                  a.shape[1])
    inner_product_u32.calls += 1
    return out


ENTRY_POINTS = (expand_key, prf_eval_u64, prf_offset_table, xor_scan,
                l2_batch, inner_product_u32)


def reset_calls() -> None:
    for fn in ENTRY_POINTS:
        fn.calls = 0


reset_calls()
