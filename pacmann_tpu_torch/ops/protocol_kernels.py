"""The client's slot selection as one pass per partition: kernels K3, K4.

The contracts of the JAX package's ops/protocol_kernels.py:
  - claim_select (K4, `_claim_kernel`): Phase A of the online protocol
    (pir.go:404-419). Per partition, round q takes the first eligible
    primary slot not claimed by an earlier round of the same batch; a slot
    is eligible when its cached PRF column at the round's chunk equals the
    round's offset and it is not programmed for that chunk.
  - select_full (K3, `_select_full_kernel`): the whole of _pir_select in
    one pass, i.e. the claim, the replacement and global budgets assigned
    in round order, and each round's (S,) query row (the client->server
    message, pir.go:443-448), or its dummy row when the round is not served.

The engine's "xla" route reaches the same outcome as an owner fixpoint
over all rounds at once (pir/device_engine.py); here the rounds run one
after another, as the reference scans them. Two versions of each:
  - claim_select_plain / select_full_plain: a loop over the Q rounds of
    torch ops vectorised over the P partitions;
  - claim_select_cuda / select_full_cuda: kernels K4 and K3
    (csrc/protocol.cu), no host sync. Both run one claim pass on a cluster
    of CTAs per partition over windows of SELECT_WINDOW rounds, each in
    three phases: each round's first K = min(Q, SELECT_CANDIDATES)
    eligible slots, found for all the window's rounds at once; the walk
    over the rounds in order, taking each round's first unclaimed
    candidate (a round whose K candidates are all claimed scans its row on
    from the K-th); the outputs (K4 hit and found, K3 also the budgets and
    the query rows).
claim_select and select_full route a CPU tensor to the plain version and a
CUDA tensor to the kernel; there is no fallback between them.

Offsets and program points are int32 tensors (utils/u32.py); every value
compared is below 2^31, so they equal the JAX package's u16/u32 values.
Kernel K4 takes any int32 offset, and reads nothing for a round that is
not real or whose chunk lies outside [0, S).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from pacmann_tpu_torch.utils import cuda_lib
from pacmann_tpu_torch.utils.u32 import first_true

# csrc/protocol.cu: threads per CTA; candidates kept per round, rounds a
# window, the 16-bit slot indices and each warp's buffer of slots to check
_THREADS = 512
SELECT_CANDIDATES = 16
SELECT_WINDOW = 256
MAX_SLOTS = 1 << 16
_MATCH_BUF = 160


def select_smem_bytes(Hp: int, S: int) -> int:
    """Shared memory one CTA of K3 or K4 needs, for any Q: per round of a
    window two 16-byte records (phase 1's and the walk's) and
    SELECT_CANDIDATES 16-bit candidates, the claimed bitmap, found rounds
    per chunk (K3's) and each warp's buffer of 160 slots."""
    return (SELECT_WINDOW * (32 + 2 * SELECT_CANDIDATES)
            + 4 * ((Hp + 31) // 32) + 4 * S
            + 2 * (_THREADS // 32) * _MATCH_BUF)


def select_fits(Hp: int, S: int, limit: int) -> bool:
    """Whether K3 and K4 take a partition of Hp primary slots and S chunks:
    Hp within their 16-bit slot indices and their plan (select_smem_bytes)
    within `limit` bytes of a CTA's shared memory (smem_limit)."""
    return Hp <= MAX_SLOTS and select_smem_bytes(Hp, S) <= limit


def _programmed_chunk(prog: torch.Tensor, C: int, dpp: int) -> torch.Tensor:
    """(P, Hp) chunk a slot is programmed for; -1 where it is not."""
    return torch.where(prog != dpp, torch.div(prog, C, rounding_mode="floor"),
                       -1)


def _claim_round(slot_col, pc, claimed, ck, off, real):
    """One round over all partitions: (hit (P,), found (P,)); marks the
    claimed slots in `claimed` (P, Hp) in place."""
    P, _, Hp = slot_col.shape
    dev = slot_col.device
    p_ix = torch.arange(P, device=dev)
    col = slot_col[p_ix, ck.long()]                             # (P, Hp)
    elig = (col == off[:, None]) & (pc != ck[:, None]) & ~claimed
    fnd = elig.any(dim=1) & real
    h = first_true(elig, 1)
    claimed |= fnd[:, None] & (torch.arange(Hp, device=dev) == h[:, None])
    return torch.where(fnd, h, 0).to(torch.int32), fnd


def claim_select_plain(slot_col, prog, chunk_q, off_q, real_q, *, C: int,
                       dpp: int):
    """Plain torch version of K4. slot_col (P, S, Hp) int32 cached PRF
    offsets, prog (P, Hp) int32 program points (dpp = unset), chunk_q/off_q
    (Q, P) int32, real_q (Q, P) bool. Returns (hit (Q, P) int32, found
    (Q, P) bool): round q's claimed slot, 0 where it found none."""
    Q, P = chunk_q.shape
    dev = slot_col.device
    pc = _programmed_chunk(prog, C, dpp)
    claimed = torch.zeros(tuple(prog.shape), dtype=torch.bool, device=dev)
    hit = torch.zeros((Q, P), dtype=torch.int32, device=dev)
    found = torch.zeros((Q, P), dtype=torch.bool, device=dev)
    for q in range(Q):
        hit[q], found[q] = _claim_round(slot_col, pc, claimed, chunk_q[q],
                                        off_q[q], real_q[q])
    return hit, found


def select_full_plain(slot_col, prog, tag, table, repl_idx, hist, finished,
                      idx_q, rnd_q, *, C: int, R: int, Hp: int, S: int,
                      max_q: int, dpp: int):
    """Plain torch version of K3. State as the engine holds it (int32):
    slot_col (P, S, Hp), prog/tag (P, Hp), table (P, T, S), repl_idx
    (P, S, R), hist (P, S), finished (P,); idx_q (Q, P) local indices
    (-1 = dummy round), rnd_q (Q, P, S) dummy offsets.

    Returns (sel, qs) as the engine's _pir_select: sel = (hit, ok_q, ok_r,
    ig, chunk, idxu), each (Q, P), and qs (Q, P, S) int32. For a round that
    found no slot, ig = hist[chunk] + (earlier found rounds of that chunk)
    - 1, which is -1 when both are 0; its row is the dummy row."""
    Q, P = idx_q.shape
    dev = idx_q.device
    p_ix = torch.arange(P, device=dev)
    s_ar = torch.arange(S, device=dev)
    real_q = idx_q >= 0
    idxu_q = torch.where(real_q, idx_q, 0)
    chunk_q = torch.div(idxu_q, C, rounding_mode="floor")
    off_q = idxu_q % C
    hist_own = hist[p_ix[None, :], chunk_q]                     # (Q, P)

    pc = _programmed_chunk(prog, C, dpp)
    claimed = torch.zeros((P, Hp), dtype=torch.bool, device=dev)
    found_c = torch.zeros((P, S), dtype=torch.int32, device=dev)
    rankp = torch.zeros(P, dtype=torch.int32, device=dev)
    hit = torch.zeros((Q, P), dtype=torch.int32, device=dev)
    ok_q = torch.zeros((Q, P), dtype=torch.bool, device=dev)
    ok_r = torch.zeros((Q, P), dtype=torch.bool, device=dev)
    ig = torch.zeros((Q, P), dtype=torch.int32, device=dev)
    qs = torch.empty((Q, P, S), dtype=torch.int32, device=dev)
    for q in range(Q):
        ck = chunk_q[q].long()
        h, fnd = _claim_round(slot_col, pc, claimed, chunk_q[q], off_q[q],
                              real_q[q])
        # budgets in round order: the round's group index within its chunk,
        # then its rank among the partition's admitted rounds
        g = hist_own[q] + found_c[p_ix, ck] - (~fnd).to(torch.int32)
        okr = fnd & (g < R)
        okq = okr & (rankp < max_q - finished)
        rankp += okr.to(torch.int32)
        found_c[p_ix, ck] += fnd.to(torch.int32)
        gc = torch.clamp(g, max=R - 1)
        # the query row: the hit slot's set, its programmed point, and the
        # replacement at the round's own chunk (pir.go:422-439)
        row = table[p_ix, tag[p_ix, h.long()].long()]           # (P, S)
        hp = prog[p_ix, h.long()]
        row = torch.where(
            (s_ar == torch.div(hp, C, rounding_mode="floor")[:, None])
            & (hp != dpp)[:, None], (hp % C)[:, None], row)
        r_sel = torch.where(gc >= 0, repl_idx[p_ix, ck, gc.clamp(min=0)], 0)
        row = torch.where(s_ar == ck[:, None], (r_sel % C)[:, None], row)
        qs[q] = torch.where(okq[:, None], row, rnd_q[q])
        hit[q], ok_q[q], ok_r[q], ig[q] = h, okq, okr, gc
    return (hit, ok_q, ok_r, ig, chunk_q, idxu_q), qs


@functools.cache
def smem_limit(device_index: int) -> int:
    """The shared memory one CTA of K3/K4 may use on CUDA device
    `device_index`: its opt-in limit (cudaDevAttrMaxSharedMemoryPerBlockOptin,
    232,448 B on an H100), as csrc/protocol.cu reads it."""
    fn = cuda_lib.function("protocol", "protocol_smem_limit",
                           [ctypes.c_int, ctypes.c_void_p])
    out = ctypes.c_int(0)
    cuda_lib.check(fn(device_index, ctypes.addressof(out)),
                   "protocol_smem_limit")
    return out.value


def _check_smem(Hp: int, S: int, what: str, limit: int):
    """Raise where Hp exceeds the kernels' 16-bit slot indices or a CTA's
    plan (select_smem_bytes, K3's and K4's) exceeds `limit`."""
    if Hp > MAX_SLOTS:
        raise ValueError(f"{what}: Hp={Hp} slots exceed the kernel's 16-bit "
                         f"slot indices (at most {MAX_SLOTS})")
    need = select_smem_bytes(Hp, S)
    if need > limit:
        raise ValueError(
            f"{what}: one partition needs {need} B of shared memory (Hp={Hp}, "
            f"S={S}); the card lets a kernel take at most {limit} B")


def claim_select_cuda(slot_col, prog, chunk_q, off_q, real_q, *, C: int,
                      dpp: int):
    """Kernel K4: claim_select_plain's contract on CUDA tensors. Counts its
    launches in claim_select_cuda.launches."""
    for t, name in ((slot_col, "slot_col"), (prog, "prog"),
                    (chunk_q, "chunk_q"), (off_q, "off_q")):
        cuda_lib.require_cuda_tensor(t, name, torch.int32)
    cuda_lib.require_cuda_tensor(real_q, "real_q", torch.bool)
    P, S, Hp = slot_col.shape
    Q = chunk_q.shape[0]
    dev = slot_col.device
    cuda_lib.require_shape(prog, "prog", (P, Hp), dev)
    for t, name in ((chunk_q, "chunk_q"), (off_q, "off_q"),
                    (real_q, "real_q")):
        cuda_lib.require_shape(t, name, (Q, P), dev)
    _check_smem(Hp, S, "claim_select", smem_limit(dev.index))
    hit = torch.empty((Q, P), dtype=torch.int32, device=dev)
    found = torch.empty((Q, P), dtype=torch.bool, device=dev)
    if Q == 0 or P == 0:
        return hit, found
    fn = cuda_lib.function("protocol", "claim_select", [
        ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    cuda_lib.check(
        fn(slot_col.data_ptr(), prog.data_ptr(), chunk_q.data_ptr(),
           off_q.data_ptr(), real_q.data_ptr(), hit.data_ptr(),
           found.data_ptr(), P, S, Hp, Q, C, dpp,
           cuda_lib.stream_ptr(dev)), "claim_select")
    claim_select_cuda.launches += 1
    return hit, found


claim_select_cuda.launches = 0


def select_full_cuda(slot_col, prog, tag, table, repl_idx, hist, finished,
                     idx_q, rnd_q, *, C: int, R: int, Hp: int, S: int,
                     max_q: int, dpp: int):
    """Kernel K3: select_full_plain's contract on CUDA tensors. Counts its
    launches in select_full_cuda.launches."""
    named = ((slot_col, "slot_col"), (prog, "prog"), (tag, "tag"),
             (table, "table"), (repl_idx, "repl_idx"), (hist, "hist"),
             (finished, "finished"), (idx_q, "idx_q"), (rnd_q, "rnd_q"))
    for t, name in named:
        cuda_lib.require_cuda_tensor(t, name, torch.int32)
    P = prog.shape[0]
    Q = idx_q.shape[0]
    T = table.shape[1] if table.dim() == 3 else -1
    dev = slot_col.device
    for (t, name), shape in zip(named, (
            (P, S, Hp), (P, Hp), (P, Hp), (P, T, S), (P, S, R), (P, S),
            (P,), (Q, P), (Q, P, S))):
        cuda_lib.require_shape(t, name, shape, dev)
    _check_smem(Hp, S, "select_full", smem_limit(dev.index))
    qs = torch.empty((Q, P, S), dtype=torch.int32, device=dev)
    hit, ig, chunk, idxu = (torch.empty((Q, P), dtype=torch.int32,
                                        device=dev) for _ in range(4))
    ok_q, ok_r = (torch.empty((Q, P), dtype=torch.bool, device=dev)
                  for _ in range(2))
    if Q > 0 and P > 0:
        fn = cuda_lib.function("protocol", "select_full", [
            ctypes.c_void_p] * 16 + [ctypes.c_int] * 9 + [ctypes.c_void_p])
        cuda_lib.check(
            fn(slot_col.data_ptr(), prog.data_ptr(), tag.data_ptr(),
               table.data_ptr(), repl_idx.data_ptr(), hist.data_ptr(),
               finished.data_ptr(), idx_q.data_ptr(), rnd_q.data_ptr(),
               qs.data_ptr(), hit.data_ptr(), ok_q.data_ptr(),
               ok_r.data_ptr(), ig.data_ptr(), chunk.data_ptr(),
               idxu.data_ptr(), P, S, Hp, T, R, Q, C, max_q, dpp,
               cuda_lib.stream_ptr(dev)), "select_full")
        select_full_cuda.launches += 1
    return (hit, ok_q, ok_r, ig, chunk, idxu), qs


select_full_cuda.launches = 0


def claim_select(slot_col, prog, chunk_q, off_q, real_q, *, C: int,
                 dpp: int):
    """Phase-A claim (K4's contract): the plain version for a CPU tensor,
    kernel K4 for a CUDA tensor."""
    if slot_col.device.type == "cpu":
        return claim_select_plain(slot_col, prog, chunk_q, off_q, real_q,
                                  C=C, dpp=dpp)
    return claim_select_cuda(slot_col, prog, chunk_q, off_q, real_q, C=C,
                             dpp=dpp)


def select_full(slot_col, prog, tag, table, repl_idx, hist, finished,
                idx_q, rnd_q, *, C: int, R: int, Hp: int, S: int, max_q: int,
                dpp: int):
    """The whole client selection (K3's contract): the plain version for a
    CPU tensor, kernel K3 for a CUDA tensor."""
    args = (slot_col, prog, tag, table, repl_idx, hist, finished, idx_q,
            rnd_q)
    kw = dict(C=C, R=R, Hp=Hp, S=S, max_q=max_q, dpp=dpp)
    if slot_col.device.type == "cpu":
        return select_full_plain(*args, **kw)
    return select_full_cuda(*args, **kw)
