"""The JAX package's attic (ops/attic.py): four kernels no engine path
routes, kept with the same public names as regression and
route-equivalence surfaces, each beside a plain torch version.

  - xor_hintgen_mm_s8p (K7a, `_hintgen_mm_kernel_s8p`): hint generation on
    the plane-major signed-byte DB that to_plane_major_s8 makes;
  - xor_hintgen_pallas (K7b, `_hintgen_kernel`): xor_scan_parts' contract
    on the (S, P, C*k, 128) DB, with the skip mask read beside the offsets;
  - xor_scan_pallas (K7c, `_xor_kernel`): xor_scan_xla's contract on the
    flat (S, C*k, 128) DB;
  - refresh_parity (K7d, `_refresh_kernel`): the Phase-C parity rewrite,
    with refresh_parity_np, its numpy twin.

K7a-K7c are kernel K2's gather-XOR on other layouts and share its source
(csrc/xor_gather.cu); K7d is csrc/refresh_parity.cu. K7a, K7b and K7c each
run in one of two forms that plane_form / hintgen_form / flat_form pick by
shape: "staged" (K2's chunk-major structure: a chunk's column slice staged
in shared memory and read there by a block of hints) where many hints
name each chunk row, else "row" (a warp per output row, gathering from
L2). Each computes the function, not the TPU mechanism: no one-hot
products, no block padding, no zero pad rows. Each entry point takes
numpy arrays or tensors and runs on
CUDA unless given device="cpu" or CPU tensors (cuda_lib.default_device); a
CPU tensor takes the plain version, a CUDA tensor the kernel, with no
fallback between them. u32 data are int32 tensors of the same bits
(utils/u32.py). An offset outside [0, C) at a position that is not skipped
is outside the JAX contract (its gathers fill or clamp): here it
contributes zero, as a skip does.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from pacmann_tpu_torch.ops import xor_scan
from pacmann_tpu_torch.utils import cuda_lib
from pacmann_tpu_torch.utils.u32 import from_u32


def _tensor(x, dev: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """x as a contiguous `dtype` tensor on dev; a numpy int32 target takes
    any 4-byte integer array bit for bit (u32 offsets and parities)."""
    if isinstance(x, np.ndarray):
        x = from_u32(x) if dtype == torch.int32 else torch.from_numpy(
            np.ascontiguousarray(x))
    return x.to(device=dev, dtype=dtype).contiguous()


def _require(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple,
             device: torch.device):
    cuda_lib.require_cuda_tensor(t, name, dtype)
    cuda_lib.require_shape(t, name, shape, device)


# The staged forms read a chunk's whole slice once per block of hints, the
# row forms only the rows their offsets name. K7a's staged ring holds 2 x
# (C + 1) rows of 128 B beside K2's offset runs for 1,280 hints: 192,768 B
# at C = 512 (its entry refuses C above 667 on an H100). K7c's holds 2 x
# (C + 1) rows of 32 B and 16-bit row indices for up to 5,120 hints: about
# 151 KB at C = 2,048 (C above 3,310 refused); its 16-bit indices alone
# would allow C < 65,535. K7b's has K2's chunk geometry, fed K7c's way:
# 2 x (C + 1) rows of 64 B and each chunk's 16-bit row indices for 2,560
# hints, 76 KB at C = 512 (C above 1,735 refused); it takes K2's rule.
# K7c's staged form also copies the DB slice-major
# in each call, and runs one CTA a (slice, hint block): on the H100 it
# lost to the row form at B = 9C (0.67 against 0.39 ms at C = 1,000, S =
# 301) and at 14C (2.31 against 1.99 ms at C = 2,048, S = 492), and won at
# 28C (3.12 against 3.96 ms); the lines through those cross near 18C.
PLANE_STAGED_MIN_REUSE = 16
PLANE_STAGED_MAX_C = 512
HINTGEN_STAGED_MIN_REUSE = 16
HINTGEN_STAGED_MAX_C = 512
FLAT_STAGED_MIN_REUSE = 20
FLAT_STAGED_MAX_C = 3072
FORMS = ("staged", "row")


def plane_form(P: int, B: int, S: int, C: int, k: int) -> str:
    """K7a's form for a (P, B) output over S chunks of C entries of k rows:
    "staged" where B >= PLANE_STAGED_MIN_REUSE * C and C <=
    PLANE_STAGED_MAX_C, else "row". Deterministic, and no fallback: the
    form chosen launches or raises."""
    if B >= PLANE_STAGED_MIN_REUSE * C and C <= PLANE_STAGED_MAX_C:
        return "staged"
    return "row"


def hintgen_form(P: int, B: int, S: int, C: int, k: int) -> str:
    """K7b's form for a (P, B) output over S chunks of C entries of k rows:
    "staged" where B >= HINTGEN_STAGED_MIN_REUSE * C and C <=
    HINTGEN_STAGED_MAX_C (K2's gather_form rule), else "row".
    Deterministic, and no fallback."""
    if B >= HINTGEN_STAGED_MIN_REUSE * C and C <= HINTGEN_STAGED_MAX_C:
        return "staged"
    return "row"


def flat_form(B: int, S: int, C: int, k: int) -> str:
    """K7c's form for B rows over S chunks of C entries of k rows:
    "staged" where B >= FLAT_STAGED_MIN_REUSE * C and C <=
    FLAT_STAGED_MAX_C, else "row". Deterministic, and no fallback."""
    if B >= FLAT_STAGED_MIN_REUSE * C and C <= FLAT_STAGED_MAX_C:
        return "staged"
    return "row"


def _form_flag(form: str) -> int:
    if form not in FORMS:
        raise ValueError(f"unknown form {form!r}: one of {FORMS}")
    return int(form == "staged")


# ---------------------------------------------------------------------------
# K7a: the plane-major signed-byte scan


def to_plane_major_s8(db4, k: int, device=None) -> torch.Tensor:
    """(S, P, C*k, 128) u32 chunk-major DB -> (S, P, 4, C, E) int8 byte
    planes, E = k*128: plane b holds byte b of each u32 word, read as a
    signed byte. Same total bytes as db4 (one copy: a byte view of the
    little-endian words, permuted)."""
    dev = cuda_lib.default_device(db4, device)
    x = _tensor(db4, dev, torch.int32)
    S, P, CK, _ = x.shape
    C, E = CK // k, k * 128
    planes = x.reshape(S, P, C, E).view(torch.uint8).reshape(S, P, C, E, 4)
    return planes.permute(0, 1, 4, 2, 3).contiguous().view(torch.int8)


def xor_hintgen_mm_s8p_plain(dbp: torch.Tensor,
                             offsets: torch.Tensor) -> torch.Tensor:
    """Plain torch version of K7a: dbp (S, P, 4, C, E) int8, offsets
    (P, T, S) int32 (skips folded in as C) -> (P, T, E) int32. Each plane
    is XOR-accumulated as bytes (& 0xFF undoes the sign extension) and the
    words are assembled once, in int64."""
    S, P, _, C, E = dbp.shape
    T = offsets.shape[1]
    p_ix = torch.arange(P, device=dbp.device)[:, None]
    acc = torch.zeros((4, P, T, E), dtype=torch.int32, device=dbp.device)
    for s in range(S):
        off = offsets[:, :, s]
        live = ((off >= 0) & (off < C))[:, :, None]
        rows = torch.where(live[:, :, 0], off, 0).long()
        for b in range(4):
            g = dbp[s, :, b][p_ix, rows].to(torch.int32) & 0xFF  # (P, T, E)
            acc[b] ^= torch.where(live, g, 0)
    words = sum(acc[b].to(torch.int64) << (8 * b) for b in range(4))
    return torch.where(words >= 1 << 31, words - (1 << 32),
                       words).to(torch.int32)


def xor_hintgen_mm_s8p_cuda(dbp: torch.Tensor, offsets: torch.Tensor,
                            form: str | None = None) -> torch.Tensor:
    """Kernel K7a: xor_hintgen_mm_s8p_plain's contract on CUDA tensors, in
    `form` ("staged" or "row"; None: plane_form's choice). The staged form
    XORs each plane's bytes into scratch as large as its output, allocated
    here, and then assembles the words. Counts its launches in
    xor_hintgen_mm_s8p_cuda.launches."""
    cuda_lib.require_cuda_tensor(dbp, "dbp", torch.int8)
    S, P, planes, C, E = dbp.shape
    if planes != 4 or E % 128 or E == 0:
        raise ValueError(f"dbp {tuple(dbp.shape)} is not an (S, P, 4, C, "
                         "k*128) plane-major layout")
    T = offsets.shape[1] if offsets.dim() == 3 else -1
    _require(offsets, "offsets", torch.int32, (P, T, S), dbp.device)
    form = form or plane_form(P, T, S, C, E // 128)
    staged = _form_flag(form)
    # the staged form's output as byte planes, before the words are
    # assembled
    scratch = torch.empty((P, T, 4 * E) if staged else (0,),
                          dtype=torch.int8, device=dbp.device)
    out = torch.empty((P, T, E), dtype=torch.int32, device=dbp.device)
    fn = cuda_lib.function("xor_gather", "xor_hintgen_planes", [
        ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    cuda_lib.check(
        fn(dbp.data_ptr(), offsets.data_ptr(), scratch.data_ptr(),
           out.data_ptr(), S, P, C, E // 128, T, staged,
           cuda_lib.stream_ptr(dbp.device)), f"xor_hintgen_planes ({form})")
    xor_hintgen_mm_s8p_cuda.launches += 1
    return out


xor_hintgen_mm_s8p_cuda.launches = 0


def xor_hintgen_mm_s8p(dbp, table, skip, k: int, sc: int = 1,
                       device=None) -> torch.Tensor:
    """Hint generation over a plane-major s8 DB (see to_plane_major_s8),
    xor_hintgen_mm's contract: table (P, T, S) u32 offsets, skip (P, T, S)
    bool -> (P, T, k*128) parities. sc (chunks per TPU grid step) has no
    meaning on the card; it must still divide S, as the JAX function
    requires, else ValueError."""
    dev = cuda_lib.default_device(dbp, device)
    dbp = _tensor(dbp, dev, torch.int8)
    S, C, E = dbp.shape[0], dbp.shape[3], dbp.shape[4]
    if S % sc:
        raise ValueError(f"sc={sc} must divide S={S}")
    if E != k * 128:
        raise ValueError(f"dbp rows of {E} words do not hold k={k} rows")
    # the JAX wrapper's skip fold (_hintgen_mm_offsets), without its
    # transpose and hint-axis padding
    off = torch.where(_tensor(skip, dev, torch.bool), C,
                      _tensor(table, dev, torch.int32)).contiguous()
    if dev.type == "cpu":
        return xor_hintgen_mm_s8p_plain(dbp, off)
    return xor_hintgen_mm_s8p_cuda(dbp, off)


# ---------------------------------------------------------------------------
# K7b: partition-major gather with the skip mask


def xor_hintgen_pallas_plain(db4: torch.Tensor, offsets: torch.Tensor,
                             skip: torch.Tensor, k: int) -> torch.Tensor:
    """Plain torch version of K7b: db4 (S, P, C*k, 128) int32, offsets
    (P, B, S) int32, skip (P, B, S) bool -> (P, B, k, 128) int32."""
    P, B, _ = offsets.shape
    off = torch.where(skip, xor_scan.SKIP, offsets)
    return xor_scan.xor_gather_plain(db4, off, k).reshape(P, B, k, 128)


def xor_hintgen_pallas_cuda(db4: torch.Tensor, offsets: torch.Tensor,
                            skip: torch.Tensor, k: int,
                            form: str | None = None) -> torch.Tensor:
    """Kernel K7b: xor_hintgen_pallas_plain's contract on CUDA tensors, in
    `form` ("staged" or "row"; None: hintgen_form's choice). The staged
    form first writes (P, S, B) 16-bit row indices, the mask folded in,
    into scratch allocated here (B rounded up to 8). Counts its
    launches in xor_hintgen_pallas_cuda.launches."""
    cuda_lib.require_cuda_tensor(db4, "db4", torch.int32)
    S, P, CK, L = db4.shape
    if L != 128 or k < 1 or CK % k:
        raise ValueError(f"db4 {tuple(db4.shape)} with k={k} is not a "
                         "(S, P, C*k, 128) layout")
    B = offsets.shape[1] if offsets.dim() == 3 else -1
    _require(offsets, "offsets", torch.int32, (P, B, S), db4.device)
    _require(skip, "skip", torch.bool, (P, B, S), db4.device)
    C = CK // k
    form = form or hintgen_form(P, B, S, C, k)
    staged = _form_flag(form)
    scratch = torch.empty(P * S * (-(-B // 8) * 8) if staged else 0,
                          dtype=torch.int16, device=db4.device)
    out = torch.empty((P, B, k, L), dtype=torch.int32, device=db4.device)
    fn = cuda_lib.function("xor_gather", "xor_hintgen_skip", [
        ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    cuda_lib.check(
        fn(db4.data_ptr(), offsets.data_ptr(), skip.data_ptr(),
           scratch.data_ptr(), out.data_ptr(), S, P, C, k, B, staged,
           cuda_lib.stream_ptr(db4.device)), f"xor_hintgen_skip ({form})")
    xor_hintgen_pallas_cuda.launches += 1
    return out


xor_hintgen_pallas_cuda.launches = 0


def xor_hintgen_pallas(db4, offsets, skip, k: int,
                       device=None) -> torch.Tensor:
    """Hint generation on the partition-major DB (xor_scan_parts'
    contract): db4 (S, P, C*k, 128) u32, offsets (P, B, S) u32, skip
    (P, B, S) bool -> (P, B, k, 128) parities."""
    dev = cuda_lib.default_device(db4, device)
    args = (_tensor(db4, dev, torch.int32), _tensor(offsets, dev, torch.int32),
            _tensor(skip, dev, torch.bool), k)
    if dev.type == "cpu":
        return xor_hintgen_pallas_plain(*args)
    return xor_hintgen_pallas_cuda(*args)


# ---------------------------------------------------------------------------
# K7c: the flat-layout scan


def xor_scan_pallas_plain(db: torch.Tensor, offsets: torch.Tensor,
                          skip: torch.Tensor, k: int) -> torch.Tensor:
    """Plain torch version of K7c: db (S, C*k, 128) int32, offsets and
    skip (B, S) -> (B, k, 128) int32."""
    return xor_hintgen_pallas_plain(db[:, None], offsets[None], skip[None],
                                    k)[0]


def xor_scan_pallas_cuda(db: torch.Tensor, offsets: torch.Tensor,
                         skip: torch.Tensor, k: int,
                         form: str | None = None) -> torch.Tensor:
    """Kernel K7c: xor_scan_pallas_plain's contract on CUDA tensors, in
    `form` ("staged" or "row"; None: flat_form's choice). The staged form
    first copies db slice-major and writes the (S, B) 16-bit row indices
    into scratch of db's size and a little more, allocated here. Counts its
    launches in xor_scan_pallas_cuda.launches."""
    cuda_lib.require_cuda_tensor(db, "db", torch.int32)
    S, CK, L = db.shape
    if L != 128 or k < 1 or CK % k:
        raise ValueError(f"db {tuple(db.shape)} with k={k} is not an "
                         "(S, C*k, 128) layout")
    B = offsets.shape[0]
    _require(offsets, "offsets", torch.int32, (B, S), db.device)
    _require(skip, "skip", torch.bool, (B, S), db.device)
    C = CK // k
    form = form or flat_form(B, S, C, k)
    staged = _form_flag(form)
    # the staged form's slice-major copy of db, then its (S, B) row
    # indices, B rounded up to 8 (16-byte copies)
    scratch = torch.empty(
        db.numel() * 4 + S * (-(-B // 8) * 8) * 2 if staged else 0,
        dtype=torch.uint8, device=db.device)
    out = torch.empty((B, k, L), dtype=torch.int32, device=db.device)
    fn = cuda_lib.function("xor_gather", "xor_scan_flat", [
        ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    cuda_lib.check(
        fn(db.data_ptr(), offsets.data_ptr(), skip.data_ptr(),
           scratch.data_ptr(), out.data_ptr(), S, C, k, B, staged,
           cuda_lib.stream_ptr(db.device)), f"xor_scan_flat ({form})")
    xor_scan_pallas_cuda.launches += 1
    return out


xor_scan_pallas_cuda.launches = 0


def xor_scan_pallas(db, offsets, skip, k: int, block_b: int = 2048,
                    device=None) -> torch.Tensor:
    """The XOR scan on the flat DB (xor_scan_xla's contract): db
    (S, C*k, 128) u32, offsets (B, S) u32, skip (B, S) bool -> (B, k, 128)
    parities. block_b (the TPU kernel's hint block) has no meaning on the
    card and is accepted for the JAX signature."""
    dev = cuda_lib.default_device(db, device)
    args = (_tensor(db, dev, torch.int32), _tensor(offsets, dev, torch.int32),
            _tensor(skip, dev, torch.bool), k)
    if dev.type == "cpu":
        return xor_scan_pallas_plain(*args)
    return xor_scan_pallas_cuda(*args)


# ---------------------------------------------------------------------------
# K7d: the Phase-C parity refresh


def refresh_parity_plain(ppar: torch.Tensor, new_par: torch.Tensor,
                         hit: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """Plain torch version of K7d: a copy of ppar (P, Hp, Ep) with row
    hit[q, p] of partition p set to new_par[q, p] wherever ok[q, p], rounds
    in order (the last ok round wins a repeated slot); a hit outside
    [0, Hp) writes nothing, as in the TPU kernel."""
    Q, P = hit.shape
    Hp = ppar.shape[1]
    out = ppar.clone()
    p_ix = torch.arange(P, device=ppar.device)
    for q in range(Q):
        m = ok[q] & (hit[q] >= 0) & (hit[q] < Hp)
        out[p_ix[m], hit[q][m].long()] = new_par[q][m]
    return out


def refresh_parity_cuda(ppar: torch.Tensor, new_par: torch.Tensor,
                        hit: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """Kernel K7d: refresh_parity_plain's contract on CUDA tensors (Ep a
    multiple of 4). Counts its launches in refresh_parity_cuda.launches."""
    cuda_lib.require_cuda_tensor(ppar, "ppar", torch.int32)
    P, Hp, Ep = ppar.shape
    if Ep % 4:
        raise ValueError(f"ppar rows of {Ep} words: the kernel moves rows "
                         "as 16-byte vectors and needs Ep % 4 == 0")
    Q = hit.shape[0]
    _require(new_par, "new_par", torch.int32, (Q, P, Ep), ppar.device)
    _require(hit, "hit", torch.int32, (Q, P), ppar.device)
    _require(ok, "ok", torch.bool, (Q, P), ppar.device)
    out = torch.empty_like(ppar)
    fn = cuda_lib.function("refresh_parity", "refresh_parity", [
        ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    cuda_lib.check(
        fn(ppar.data_ptr(), new_par.data_ptr(), hit.data_ptr(), ok.data_ptr(),
           out.data_ptr(), P, Hp, Ep, Q, cuda_lib.stream_ptr(ppar.device)),
        "refresh_parity")
    refresh_parity_cuda.launches += 1
    return out


refresh_parity_cuda.launches = 0


def refresh_parity(ppar, new_par, hit, ok, *, device=None) -> torch.Tensor:
    """ppar (P, Hp, Ep) u32 with ppar[p, hit[q, p], :] = new_par[q, p, :]
    wherever ok[q, p], as a new tensor (the caller's ppar is unchanged);
    new_par (Q, P, Ep) u32, hit (Q, P) int32, ok (Q, P) bool. Hit slots are
    unique per partition by the claim invariant; a repeated one takes the
    last ok round's row. No engine path routes it (the engine rewrites
    parities in pir/device_engine.py::_pir_finish)."""
    dev = cuda_lib.default_device(ppar, device)
    args = (_tensor(ppar, dev, torch.int32), _tensor(new_par, dev, torch.int32),
            _tensor(hit, dev, torch.int32), _tensor(ok, dev, torch.bool))
    if dev.type == "cpu":
        return refresh_parity_plain(*args)
    return refresh_parity_cuda(*args)


def refresh_parity_np(ppar, new_par, hit, ok):
    """NumPy twin of refresh_parity."""
    out = ppar.copy()
    Q, P = hit.shape
    for p in range(P):
        for q in range(Q):
            if ok[q, p]:
                out[p, hit[q, p]] = new_par[q, p]
    return out
