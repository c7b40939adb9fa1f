"""The port's client-protocol routes against the JAX package, bit for bit.

The plain versions of kernels K4 (claim_select) and K3 (select_full)
against the JAX Pallas kernels (interpreted on the CPU), their numpy twin
and the "xla" route's owner fixpoint; then the engine on every protocol
route and the fused search on route "fused" against the JAX engine and
search on the same route. Tolerance: none, every output is an integer."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pacmann_tpu.ops import protocol_kernels as jpk
from pacmann_tpu.pir.device_engine import DevicePianoEngine as JaxEngine
from pacmann_tpu.pir.device_engine import _pir_select as jax_pir_select
from pacmann_tpu_torch.ops import protocol_kernels as tpk
from pacmann_tpu_torch.pir import device_engine as tde
from pacmann_tpu_torch.pir.convert import state_to_numpy
from pacmann_tpu_torch.pir.device_engine import STATE_KEYS
from pacmann_tpu_torch.pir.device_engine import DevicePianoEngine as TorchEngine
from pacmann_tpu_torch.utils import cuda_lib

# Tests run in several worker processes at once; torch's default of one
# intra-op thread per core oversubscribes the machine, and these tensors
# are small.
torch.set_num_threads(1)

DPP = 0x7FFFFFFF


def _t(a):
    """numpy (u16/u32/i32/bool) -> the port's tensor of the same values."""
    a = np.asarray(a)
    if a.dtype == bool:
        return torch.from_numpy(a.copy())
    return torch.from_numpy(a.astype(np.int64).astype(np.int32))


def _claim_case(rng, Q, P, S, Hp, C, contended):
    slot_col = rng.integers(0, C, size=(P, S, Hp)).astype(np.uint16)
    prog = rng.integers(0, S * C, size=(P, Hp)).astype(np.uint32)
    prog[rng.random((P, Hp)) < 0.5] = DPP
    if contended:
        # every round asks one (chunk, offset): all rounds contest one
        # eligible set per partition
        chunk_q = np.full((Q, P), rng.integers(0, S), np.int32)
        off_q = np.full((Q, P), rng.integers(0, C), np.uint32)
    else:
        chunk_q = rng.integers(0, S, size=(Q, P)).astype(np.int32)
        off_q = rng.integers(0, C, size=(Q, P)).astype(np.uint32)
    real_q = rng.random((Q, P)) < 0.9
    return slot_col, prog, chunk_q, off_q, real_q


@pytest.mark.parametrize("contended", [False, True])
@pytest.mark.parametrize("Q,P,S,Hp,C", [(16, 4, 8, 480, 32),
                                        (8, 2, 4, 256, 64)])
def test_claim_plain_matches_jax_kernel_twin_and_fixpoint(
        Q, P, S, Hp, C, contended):
    rng = np.random.default_rng(Q * 1000 + Hp + contended)
    slot_col, prog, chunk_q, off_q, real_q = _claim_case(
        rng, Q, P, S, Hp, C, contended)
    hit, found = tpk.claim_select_plain(
        _t(slot_col), _t(prog), _t(chunk_q), _t(off_q), _t(real_q),
        C=C, dpp=DPP)
    assert hit.dtype == torch.int32 and found.dtype == torch.bool
    j_hit, j_found = jpk.claim_select(
        jnp.asarray(slot_col), jnp.asarray(prog), jnp.asarray(chunk_q),
        jnp.asarray(off_q), jnp.asarray(real_q), C=C, dpp=DPP)
    n_hit, n_found = jpk.claim_select_np(slot_col, prog, chunk_q, off_q,
                                         real_q, C=C, dpp=DPP)
    f_hit, f_found = tde._claim_fixpoint(
        _t(slot_col), _t(prog), _t(chunk_q), _t(off_q), _t(real_q),
        C=C, dpp=DPP)
    for want_hit, want_found in ((j_hit, j_found), (n_hit, n_found),
                                 (f_hit, f_found)):
        assert np.array_equal(found.numpy(), np.asarray(want_found))
        assert np.array_equal(hit.numpy(), np.asarray(want_hit))


def test_claim_plain_claims_are_unique():
    rng = np.random.default_rng(8)
    slot_col, prog, chunk_q, off_q, real_q = _claim_case(
        rng, 32, 2, 4, 256, 16, contended=True)
    hit, found = tpk.claim_select_plain(
        _t(slot_col), _t(prog), _t(chunk_q), _t(off_q), _t(real_q),
        C=16, dpp=DPP)
    for p in range(2):
        taken = hit[found[:, p], p].tolist()
        assert len(taken) > 1 and len(set(taken)) == len(taken)
    # contention is real: some real rounds find every eligible slot taken
    assert bool((~found & _t(real_q)).any())


def _select_case(rng, kind, Q, P, S, Hp, C, R, max_q):
    T = Hp + S * R
    slot_col = rng.integers(0, C, size=(P, S, Hp)).astype(np.uint16)
    prog = rng.integers(0, S * C, size=(P, Hp)).astype(np.uint32)
    prog[rng.random((P, Hp)) < 0.5] = DPP
    tag = rng.integers(0, T, size=(P, Hp)).astype(np.int32)
    table = rng.integers(0, C, size=(P, T, S)).astype(np.uint16)
    repl_idx = (rng.integers(0, C, size=(P, S, R))
                + np.arange(S)[None, :, None] * C).astype(np.uint32)
    hist = rng.integers(0, R, size=(P, S)).astype(np.int32)
    finished = rng.integers(0, max_q // 2, size=(P,)).astype(np.int32)
    idx_q = rng.integers(0, S * C, size=(Q, P)).astype(np.int32)
    if kind == "contended":
        idx_q[:] = int(rng.integers(0, S * C))
    elif kind == "budget":
        # one replacement left in every chunk, one admission left overall
        hist[:] = R - 1
        finished[:] = max_q - 1
        idx_q[Q // 2:] = idx_q[0]
    elif kind == "dummy":
        idx_q[rng.random((Q, P)) < 0.5] = -1
        idx_q[:, 0] = -1
        hist[:, 0] = 0      # a dummy round's ig is then -1
    rnd = rng.integers(0, C, size=(Q, P, S)).astype(np.uint32)
    return slot_col, prog, tag, table, repl_idx, hist, finished, idx_q, rnd


SEL_NAMES = ("hit", "ok_q", "ok_r", "ig", "chunk", "idxu")


@pytest.mark.parametrize("kind", ["random", "contended", "budget", "dummy"])
def test_select_full_plain_matches_jax_kernel_and_xla_routes(kind):
    Q, P, S, Hp, C, R, max_q = 6, 4, 8, 480, 32, 5, 1000
    rng = np.random.default_rng(["random", "contended", "budget",
                                 "dummy"].index(kind) + 40)
    (slot_col, prog, tag, table, repl_idx, hist, finished, idx_q,
     rnd) = _select_case(rng, kind, Q, P, S, Hp, C, R, max_q)
    kw = dict(C=C, R=R, Hp=Hp, S=S, max_q=max_q, dpp=DPP)
    sel, qs = tpk.select_full_plain(
        _t(slot_col), _t(prog), _t(tag), _t(table), _t(repl_idx), _t(hist),
        _t(finished), _t(idx_q), _t(rnd), **kw)

    j_sel, j_qs = jpk.select_full(
        jnp.asarray(slot_col), jnp.asarray(prog), jnp.asarray(tag),
        jnp.asarray(table), jnp.asarray(repl_idx), jnp.asarray(hist),
        jnp.asarray(finished), jnp.asarray(idx_q), jnp.asarray(rnd), **kw)
    x_sel, x_qs = jax_pir_select(
        jnp.asarray(table), jnp.asarray(repl_idx),
        (jnp.asarray(tag), jnp.asarray(prog), None, jnp.asarray(slot_col),
         jnp.asarray(hist), jnp.asarray(finished)),
        jnp.asarray(idx_q), jnp.asarray(rnd), k=1, route="xla", **kw)
    f_sel, f_qs = tde._pir_select(
        _t(table), _t(repl_idx),
        (_t(tag), _t(prog), None, _t(slot_col), _t(hist), _t(finished)),
        _t(idx_q), _t(rnd), route="xla", **kw)
    for name, w_sel, w_qs in (("jax kernel", j_sel, j_qs),
                              ("jax xla", x_sel, x_qs),
                              ("port xla", f_sel, f_qs)):
        assert np.array_equal(qs.numpy(), np.asarray(w_qs).astype(np.int32)), \
            name
        for i, field in enumerate(SEL_NAMES):
            assert np.array_equal(sel[i].numpy(), np.asarray(w_sel[i])), \
                (name, field)
    ok_q, ok_r, ig = sel[1], sel[2], sel[3]
    assert bool(ok_q.any())
    if kind == "budget":
        assert int(ok_q.sum(dim=0).max()) == 1 and bool((ok_r & ~ok_q).any())
    if kind == "dummy":
        assert bool((ig == -1).any())


def _k3_model(slot_col, prog, tag, table, repl_idx, hist, finished, idx_q,
              rnd, *, C, R, S, max_q, dpp, K, window):
    """numpy model of kernel K3 (csrc/protocol.cu), window by window of
    `window` rounds, each in three phases: each round's first K eligible
    slots, found without the other rounds; the walk in round order, taking
    a round's first unclaimed candidate, and, when all K of a full list are
    claimed, the first eligible slot after the K-th that is not claimed; then
    the query rows. The claimed set, found counts and rank carry over from
    window to window. Returns (sel, qs) as select_full."""
    Q, P = idx_q.shape
    Hp = slot_col.shape[2]
    hit, ig, chunk, idxu = (np.zeros((Q, P), np.int64) for _ in range(4))
    ok_q, ok_r = (np.zeros((Q, P), bool) for _ in range(2))
    qs = np.zeros((Q, P, S), np.int64)
    for p in range(P):
        pc = np.where(prog[p] != dpp, prog[p].astype(np.int64) // C, -1)

        def eligible(ck, off, start, claimed):
            e = (slot_col[p, ck, start:] == off) & (pc[start:] != ck)
            if claimed is not None:
                e &= ~claimed[start:]
            return start + np.flatnonzero(e)

        claimed = np.zeros(Hp, bool)
        found_c = np.zeros(S, np.int64)
        rankp = 0
        for q0 in range(0, Q, window):
            rounds = []
            for q in range(q0, min(Q, q0 + window)):    # 1. candidates
                idx = int(idx_q[q, p])
                u = max(idx, 0)
                ck, off = u // C, u % C
                live = idx >= 0 and ck < S
                rounds.append((q, u, ck, off, ck < S,
                               eligible(ck, off, 0, None)[:K] if live
                               else np.zeros(0, np.int64)))
            for q, u, ck, off, in_range, cands in rounds:   # 2. the walk
                free = cands[~claimed[cands]]
                h = int(free[0]) if free.size else -1
                if h < 0 and cands.size == K:
                    rest = eligible(ck, off, int(cands[-1]) + 1, claimed)
                    h = int(rest[0]) if rest.size else -1
                fnd = h >= 0
                prev = int(found_c[ck]) if in_range else 0
                g = (int(hist[p, ck]) if in_range else 0) + prev - (not fnd)
                okr = fnd and g < R
                okq = okr and rankp < max_q - int(finished[p])
                rankp += okr
                if fnd:
                    claimed[h] = True
                    found_c[ck] += 1
                gc = min(g, R - 1)
                row = rnd[q, p].astype(np.int64)          # 3. the row
                if okq:
                    row = table[p, tag[p, h]].astype(np.int64)
                    hp = int(prog[p, h])
                    if hp != dpp and hp // C < S:
                        row[hp // C] = hp % C
                    row[ck] = int(repl_idx[p, ck, gc]) % C if gc >= 0 else 0
                qs[q, p] = row
                hit[q, p], ok_q[q, p], ok_r[q, p] = (h if fnd else 0), okq, okr
                ig[q, p], chunk[q, p], idxu[q, p] = gc, ck, u
    return (hit, ok_q, ok_r, ig, chunk, idxu), qs


@pytest.mark.parametrize("K,window", [(2, 5), (4, 7)])
@pytest.mark.parametrize("kind", ["contended", "deep"])
def test_k3_phase_model_matches_jax_kernel_and_claim_twin(kind, K, window):
    """The windowed three phases reach the serial selection's result where
    more rounds contend for one row than K keeps, so rounds scan their row
    on: contended rounds on rows of ~15 eligible slots (~1 in "contended"),
    three ids alternating on such rows in "deep"; 24 rounds in windows of 5
    or 7."""
    Q, P, S, Hp, C, R, max_q = 24, 3, 8, 480, 32, 5, 1000
    rng = np.random.default_rng(60 + K + 7 * (kind == "deep"))
    (slot_col, prog, tag, table, repl_idx, hist, finished, idx_q,
     rnd) = _select_case(rng, "contended", Q, P, S, Hp, C, R, max_q)
    ids = [int(idx_q[0, 0])]
    if kind == "deep":
        ids += [ids[0] // C * C + (ids[0] + 1) % C, (ids[0] + 3 * C) % (S * C)]
    for u in ids:
        dense = rng.random((P, Hp)) < 0.03
        slot_col[:, u // C][dense] = u % C
        prog[dense] = DPP
    idx_q[:] = np.array([ids[q * 7 // 3 % len(ids)] for q in range(Q)])[:, None]
    idx_q[rng.random((Q, P)) < 0.1] = -1
    hist[:] = 0
    kw = dict(C=C, R=R, S=S, max_q=max_q, dpp=DPP)
    sel, qs = _k3_model(slot_col, prog, tag, table, repl_idx, hist, finished,
                        idx_q, rnd, K=K, window=window, **kw)
    j_sel, j_qs = jpk.select_full(
        jnp.asarray(slot_col), jnp.asarray(prog), jnp.asarray(tag),
        jnp.asarray(table), jnp.asarray(repl_idx), jnp.asarray(hist),
        jnp.asarray(finished), jnp.asarray(idx_q), jnp.asarray(rnd), Hp=Hp,
        **kw)
    assert np.array_equal(qs, np.asarray(j_qs).astype(np.int64))
    for i, field in enumerate(SEL_NAMES):
        assert np.array_equal(sel[i], np.asarray(j_sel[i])), field
    real = idx_q >= 0
    n_hit, n_found = jpk.claim_select_np(
        slot_col, prog, sel[4].astype(np.int32), (sel[5] % C).astype(np.uint32),
        real, C=C, dpp=DPP)
    assert np.array_equal(sel[0], n_hit)
    # more rounds than K found a slot of one row: some scanned it on
    assert int(np.asarray(n_found).sum(axis=0).min()) > K + 2


def _k4_model(slot_col, prog, chunk_q, off_q, real_q, *, C, dpp, K, window):
    """numpy model of kernel K4 (csrc/protocol.cu's claim pass, without
    K3's budgets and rows), window by window of `window` rounds: each
    round's first K eligible slots, found without the other rounds (none
    for a round that is not real or whose chunk lies outside [0, S)); then
    the walk in round order, taking a round's first unclaimed candidate
    and, when all K of a full list are claimed, the first eligible slot
    after the K-th that is not claimed. The claimed set carries over from
    window to window. Returns (hit, found) as claim_select."""
    Q, P = chunk_q.shape
    S, Hp = slot_col.shape[1:]
    hit = np.zeros((Q, P), np.int64)
    found = np.zeros((Q, P), bool)
    for p in range(P):
        pc = np.where(prog[p] != dpp, prog[p].astype(np.int64) // C, -1)

        def eligible(ck, off, start, claimed):
            e = ((slot_col[p, ck, start:].astype(np.int64) == off)
                 & (pc[start:] != ck))
            if claimed is not None:
                e &= ~claimed[start:]
            return start + np.flatnonzero(e)

        claimed = np.zeros(Hp, bool)
        for q0 in range(0, Q, window):
            rounds = []
            for q in range(q0, min(Q, q0 + window)):    # 1. candidates
                ck, off = int(chunk_q[q, p]), int(off_q[q, p])
                live = bool(real_q[q, p]) and 0 <= ck < S
                rounds.append((q, ck, off, eligible(ck, off, 0, None)[:K]
                               if live else np.zeros(0, np.int64)))
            for q, ck, off, cands in rounds:            # 2. the walk
                free = cands[~claimed[cands]]
                h = int(free[0]) if free.size else -1
                if h < 0 and cands.size == K:
                    rest = eligible(ck, off, int(cands[-1]) + 1, claimed)
                    h = int(rest[0]) if rest.size else -1
                if h >= 0:                              # 3. the outputs
                    claimed[h] = True
                    hit[q, p], found[q, p] = h, True
    return hit, found


def _k4_case(rng, kind, Q, P, S, Hp, C):
    """K4's rounds: "contended" (every round of a partition asks one
    (chunk, offset) of a row with ~15 eligible slots); "deep" (three pairs
    alternating, their rows 3 % denser); "edge" (rounds the engines never
    send: offset -1 on rows holding it at a few slots, unreal rounds with
    any chunk and offset, real rounds with a chunk of -1 or S)."""
    slot_col, prog, chunk_q, off_q, real_q = _claim_case(
        rng, Q, P, S, Hp, C, contended=kind != "edge")
    slot_col = slot_col.astype(np.int32)
    off_q = off_q.astype(np.int32)
    if kind == "deep":
        pairs = [(int(chunk_q[0, 0]), int(off_q[0, 0])),
                 (int(chunk_q[0, 0]), (int(off_q[0, 0]) + 1) % C),
                 ((int(chunk_q[0, 0]) + 3) % S, int(off_q[0, 0]))]
        for ck, off in pairs:
            dense = rng.random((P, Hp)) < 0.03
            slot_col[:, ck][dense] = off
            prog[dense] = DPP
        at = [q * 7 // 3 % len(pairs) for q in range(Q)]
        chunk_q[:] = np.array([pairs[i][0] for i in at])[:, None]
        off_q[:] = np.array([pairs[i][1] for i in at])[:, None]
    elif kind == "edge":
        slot_col[rng.random((P, S, Hp)) < 0.005] = -1
        neg = rng.random((Q, P)) < 0.4
        chunk_q[neg] = rng.integers(0, 2, size=(Q, P))[neg]
        off_q[neg] = -1
        junk = ~real_q
        chunk_q[junk] = rng.choice([-1, S, S + 7, -(1 << 30), 1 << 30],
                                   size=(Q, P))[junk]
        off_q[junk] = rng.integers(-(1 << 31), 1 << 31, size=(Q, P),
                                   dtype=np.int64)[junk]
        out = real_q & (rng.random((Q, P)) < 0.1)
        chunk_q[out] = rng.choice([-1, S], size=(Q, P))[out]
    return slot_col, prog, chunk_q, off_q, real_q


@pytest.mark.parametrize("K,window", [(2, 5), (4, 7)])
@pytest.mark.parametrize("kind", ["contended", "deep", "edge"])
def test_k4_claim_pass_model_matches_jax_kernel_and_twin(kind, K, window):
    """K4's windowed claim pass reaches the serial claim's result where more
    rounds contend for one row than K keeps, so rounds scan their row on
    (24 rounds in windows of 5 or 7), and on the edge input (Hp % 4 = 3).
    The JAX kernel (interpreted), its numpy twin and the port's plain
    version get the edge rounds that are not real or out of range as unreal
    rounds on chunk 0, offset 0: by the contract such a round finds nothing
    and claims nothing, whatever its chunk and offset."""
    Q, P, S, C = 24, 3, 8, 32
    Hp = 483 if kind == "edge" else 480
    rng = np.random.default_rng(70 + K + 7 * ["contended", "deep",
                                              "edge"].index(kind))
    slot_col, prog, chunk_q, off_q, real_q = _k4_case(rng, kind, Q, P, S, Hp,
                                                      C)
    hit, found = _k4_model(slot_col, prog, chunk_q, off_q, real_q, C=C,
                           dpp=DPP, K=K, window=window)
    live = real_q & (chunk_q >= 0) & (chunk_q < S)
    safe = (np.where(live, chunk_q, 0).astype(np.int32),
            np.where(live, off_q, 0).astype(np.int32), live)
    j_hit, j_found = jpk.claim_select(
        jnp.asarray(slot_col), jnp.asarray(prog), *map(jnp.asarray, safe),
        C=C, dpp=DPP)
    n_hit, n_found = jpk.claim_select_np(slot_col, prog, *safe, C=C, dpp=DPP)
    t_hit, t_found = tpk.claim_select_plain(
        _t(slot_col), _t(prog), *map(_t, safe), C=C, dpp=DPP)
    for want_hit, want_found in ((j_hit, j_found), (n_hit, n_found),
                                 (t_hit.numpy(), t_found.numpy())):
        assert np.array_equal(found, np.asarray(want_found))
        assert np.array_equal(hit, np.asarray(want_hit))
    if kind == "edge":
        neg = live & (off_q == -1)
        assert (found & neg).any() and (~found & neg).any()
        assert not found[real_q & ~live].any()
    else:
        # more rounds than K found a slot of one row: some scanned it on
        assert int(found.sum(axis=0).min()) > K + 2


def _engine_pair(route, n=2048, seed=0, prep_seed=7):
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 2**32, size=(n, 8), dtype=np.uint32)
    ref = JaxEngine(n, 32, 32, raw, 20, kernel_route=route)
    got = TorchEngine(n, 32, 32, raw, 20, device="cpu", kernel_route=route)
    ref.preprocessing(rng=np.random.default_rng(prep_seed))
    got.preprocessing(rng=np.random.default_rng(prep_seed))
    return raw, ref, got


def _assert_same_state(ref, got):
    want = {k: np.asarray(v).astype(np.uint32) for k, v in ref.state.items()}
    have = state_to_numpy(got.state)
    for key in STATE_KEYS:
        assert np.array_equal(have[key], want[key]), key
    assert got.queries_made_in_partition == ref.queries_made_in_partition


@pytest.mark.parametrize("route", ["xla", "pallas", "fused"])
def test_engine_route_matches_jax_engine(route):
    """Prep, three query batches (spread, duplicate, one partition
    overflowing) and one contended round: identical answers and state."""
    raw, ref, got = _engine_pair(route)
    assert got.kernel_route == route
    _assert_same_state(ref, got)
    c = ref.config
    rng = np.random.default_rng(2)
    spread = [int(i * c.partition_size + rng.integers(0, c.partition_size))
              for i in range(c.partition_num)] * 2
    for ids in (spread, [7] * 32, list(range(100, 132))):
        out = got.query(ids)
        assert np.array_equal(out, ref.query(ids))
        _assert_same_state(ref, got)
    for r, idx in enumerate(spread):
        assert np.array_equal(got.cache[idx], raw[idx]), r
    # contended round: every round of every partition asks index 17
    p = ref.params
    Q, P = 16, c.partition_num
    idx_q = np.full((Q, P), 17, np.int32)
    rand_offs = (np.random.default_rng(9).integers(
        0, 2**32, size=(Q, P, p.set_size), dtype=np.uint64)
        & np.uint64(p.chunk_mask)).astype(np.uint32)
    ref.state, e_ref, ok_ref = ref._online(idx_q, rand_offs)
    e_got, ok_got = got._online(idx_q, rand_offs)
    assert np.array_equal(ok_got.numpy(), np.asarray(ok_ref))
    assert np.array_equal(e_got.numpy().view(np.uint32), np.asarray(e_ref))
    assert 1 <= int(ok_got.sum(dim=0).min()) < Q
    _assert_same_state(ref, got)


def test_fused_search_fused_route_matches_jax():
    """The fused search on route "fused", with the JAX search's own draws
    handed to the port: ids, steps, counters and state match."""
    import jax

    from pacmann_tpu.private.fused_search import FusedPrivateSearch as JS
    from pacmann_tpu.private.fused_search import _draw_step_randoms
    from pacmann_tpu.private.oracle import pack_vertex_db
    from pacmann_tpu_torch.private.fused_search import (
        FusedPrivateSearch as TS)

    rng = np.random.default_rng(31)
    n, d, m = 1024, 8, 8
    vectors = rng.integers(0, 8, size=(n, d)).astype(np.float32)
    graph = rng.integers(0, n, size=(n, m))
    raw = pack_vertex_db(vectors, graph)
    sids = rng.choice(n, 32, replace=False)
    ref_e = JaxEngine(n, 4 * (d + m), m, raw, 8, kernel_route="fused")
    got_e = TorchEngine(n, 4 * (d + m), m, raw, 8, device="cpu",
                        kernel_route="fused")
    searches = []
    for e, Search in ((ref_e, JS), (got_e, TS)):
        e.preprocessing(rng=np.random.default_rng(99))
        searches.append(Search(e, sids, vectors[sids], graph[sids], dim=d,
                               m=m, n=n))
    ref, got = searches
    queries = rng.integers(0, 8, size=(1, d)).astype(np.float32)
    ids_r, st_r = ref.search(queries, k=5, max_step=5, parallel=3, seed=7,
                             return_steps=True)
    # the JAX search's own per-step draws for seed 7
    P = ref_e.config.partition_num
    draws = _draw_step_randoms(
        jax.random.split(jax.random.PRNGKey(7), 5), Qn=1, parallel=3, m=m,
        n=n, quota=3 * m // P, P=P, S=ref_e.params.set_size,
        C=ref_e.params.chunk_size)
    ids_g, st_g = got.search(queries, k=5, max_step=5, parallel=3,
                             step_randoms=[np.asarray(a) for a in draws],
                             return_steps=True)
    assert (ids_g >= 0).any()
    assert np.array_equal(ids_g, ids_r) and np.array_equal(st_g, st_r)
    assert np.array_equal(got.fetch_stats, ref.fetch_stats)
    _assert_same_state(ref_e, got_e)


def test_resolve_route(monkeypatch):
    monkeypatch.delenv("PACMANN_PROTOCOL_ROUTE", raising=False)
    assert tde.resolve_route(None, "cpu") == "xla"
    assert tde.resolve_route("fused", "cpu") == "fused"
    assert tde.resolve_route("auto", "cpu") == "xla"
    assert tde.resolve_route("auto", "cuda") == "pallas"
    monkeypatch.setenv("PACMANN_PROTOCOL_ROUTE", "pallas")
    assert tde.resolve_route(None, "cpu") == "pallas"
    assert tde.resolve_route("xla", "cpu") == "xla"     # explicit wins
    monkeypatch.setenv("PACMANN_PROTOCOL_ROUTE", "auto")
    assert tde.resolve_route(None, "cpu") == "xla"
    for bad in ("triton", "Fused", ""):
        with pytest.raises(ValueError):
            tde.resolve_route(bad, "cpu")
    with pytest.raises(ValueError):
        TorchEngine(2048, 32, 32, np.zeros((2048, 8), np.uint32), 20,
                    device="cpu", kernel_route="cuda")


# the H100's opt-in shared memory a CTA (protocol_kernels.smem_limit)
H100_SMEM = 232_448


@pytest.mark.parametrize("env,route,device,shape,table,limit,want", [
    # the default: "xla" on the CPU, "fused" on CUDA where K3 can serve
    (None, None, "cpu", (3584, 124), True, H100_SMEM, "xla"),
    (None, None, "cuda:0", (3584, 124), True, H100_SMEM, "fused"),
    (None, None, "cuda:0", (7168, 196), True, H100_SMEM, "fused"),
    (None, None, "cuda:0", (57344, 764), True, H100_SMEM, "fused"),
    # ... and "xla" where it cannot: past the 16-bit slots, a plan over
    # the card's limit, a table-free client, a shape not given
    (None, None, "cuda:0", (tpk.MAX_SLOTS + 1, 124), True, H100_SMEM,
     "xla"),
    (None, None, "cuda:0", (3584, 8192), True, 48 * 1024, "xla"),
    (None, None, "cuda:0", (3584, 8192), True, H100_SMEM, "fused"),
    (None, None, "cuda:0", (3584, 124), False, H100_SMEM, "xla"),
    (None, None, "cuda:0", None, True, H100_SMEM, "xla"),
    # an explicit route and the environment win, as before
    (None, "xla", "cuda:0", (3584, 124), True, H100_SMEM, "xla"),
    (None, "pallas", "cuda:0", (3584, 124), True, H100_SMEM, "pallas"),
    (None, "auto", "cuda:0", (3584, 124), True, H100_SMEM, "pallas"),
    (None, "fused", "cuda:0", (tpk.MAX_SLOTS + 1, 124), True, H100_SMEM,
     "fused"),
    ("xla", None, "cuda:0", (3584, 124), True, H100_SMEM, "xla"),
    ("pallas", None, "cuda:0", (7168, 196), True, H100_SMEM, "pallas"),
    ("fused", None, "cpu", (3584, 124), True, H100_SMEM, "fused"),
    ("pallas", "fused", "cuda:0", (3584, 124), True, H100_SMEM, "fused"),
])
def test_resolve_route_default_by_device_and_shape(
        monkeypatch, env, route, device, shape, table, limit, want):
    """The default route: "fused" (K3) on a CUDA device where K3 takes the
    shape (Hp within its 16-bit slots, its plan within the card's shared
    memory) and the client holds the table, else "xla"; a named route and
    $PACMANN_PROTOCOL_ROUTE come first. smem_limit stands in for the card
    (and must not be asked on the CPU)."""
    def limit_of(index):
        assert index == 0 and torch.device(device).type == "cuda"
        return limit

    monkeypatch.setattr(tpk, "smem_limit", limit_of)
    if env is None:
        monkeypatch.delenv("PACMANN_PROTOCOL_ROUTE", raising=False)
    else:
        monkeypatch.setenv("PACMANN_PROTOCOL_ROUTE", env)
    Hp, S = shape if shape is not None else (None, None)
    assert tde.resolve_route(route, device, Hp=Hp, S=S, table=table) == want


@pytest.mark.parametrize("route", ["xla", "fused"])
def test_engine_route_counts_fused_selections(monkeypatch, route):
    """Under tracing, an engine on route "fused" counts select.fused once a
    round of its query() calls and no claim-fixpoint sync; on "xla" the
    reverse. Answers and state stay the JAX engine's (so the two routes'
    states are equal)."""
    from pacmann_tpu_torch.utils import trace

    monkeypatch.delenv("PACMANN_PROTOCOL_ROUTE", raising=False)
    raw, ref, got = _engine_pair(route)
    assert got.protocol_route == route
    c = ref.config
    rng = np.random.default_rng(4)
    batches = [[int(i) for i in rng.integers(0, c.db_size, 32)]
               for _ in range(3)] + [[7] * 32]
    with trace.enabled():
        for ids in batches:
            assert np.array_equal(got.query(ids), ref.query(ids))
    counters = trace.read().counters
    _assert_same_state(ref, got)
    rounds = counters["query.rounds"]
    assert rounds >= len(batches)
    if route == "fused":
        assert counters.get("select.fused") == rounds
        assert "sync.claim" not in counters
    else:
        assert "select.fused" not in counters
        assert counters["sync.claim"] >= rounds


def test_engine_default_route_on_cpu_is_xla(monkeypatch):
    """With no route named, a CPU engine and a table-free one take "xla"
    and never ask the card's shared-memory limit."""
    def no_card(index):
        raise AssertionError("smem_limit asked for a CPU engine")

    monkeypatch.setattr(tpk, "smem_limit", no_card)
    monkeypatch.delenv("PACMANN_PROTOCOL_ROUTE", raising=False)
    raw = np.zeros((2048, 8), np.uint32)
    for table_free in (False, True):
        e = TorchEngine(2048, 32, 32, raw, 20, device="cpu",
                        table_free=table_free)
        assert e.kernel_route is None and e.protocol_route == "xla"


def test_engine_route_is_fixed_at_construction(monkeypatch):
    """An engine resolves its route once, when it is built: changing
    $PACMANN_PROTOCOL_ROUTE afterwards changes neither its protocol_route
    nor the route its rounds take (K4's claim_select once a round, no
    select.fused), and resolve_route is asked once a construction and
    never a round. Answers and state stay the JAX engine's."""
    from pacmann_tpu_torch.utils import trace

    resolves, claims = [], []
    resolve, claim = tde.resolve_route, tpk.claim_select

    def counted_resolve(*a, **kw):
        resolves.append(a)
        return resolve(*a, **kw)

    def counted_claim(*a, **kw):
        claims.append(1)
        return claim(*a, **kw)

    monkeypatch.setattr(tde, "resolve_route", counted_resolve)
    monkeypatch.setattr(tpk, "claim_select", counted_claim)
    monkeypatch.setenv("PACMANN_PROTOCOL_ROUTE", "pallas")
    raw = np.random.default_rng(0).integers(0, 2**32, size=(2048, 8),
                                            dtype=np.uint32)
    ref = JaxEngine(2048, 32, 32, raw, 20, kernel_route="pallas")
    got = TorchEngine(2048, 32, 32, raw, 20, device="cpu")
    for e in (ref, got):
        e.preprocessing(rng=np.random.default_rng(7))
    assert len(resolves) == 1 and got.protocol_route == "pallas"
    rng = np.random.default_rng(4)
    for env in ("fused", "xla"):
        monkeypatch.setenv("PACMANN_PROTOCOL_ROUTE", env)
        with trace.enabled():
            for _ in range(2):
                ids = [int(i) for i in rng.integers(0, 2048, 32)]
                assert np.array_equal(got.query(ids), ref.query(ids))
        counters = trace.read().counters
        assert got.protocol_route == "pallas"
        assert len(claims) == counters["query.rounds"] >= 2
        assert "select.fused" not in counters
        assert "sync.claim" not in counters
        claims.clear()
    _assert_same_state(ref, got)
    assert len(resolves) == 1
    assert TorchEngine(2048, 32, 32, raw, 20,
                       device="cpu").protocol_route == "xla"
    assert len(resolves) == 2


def test_cpu_tensors_take_the_plain_versions(monkeypatch):
    """A CPU tensor never reaches cuda_lib; the kernel wrappers refuse it."""
    def no_cuda(*a, **k):
        raise AssertionError("cuda_lib reached with CPU tensors")

    monkeypatch.setattr(cuda_lib, "load", no_cuda)
    monkeypatch.setattr(cuda_lib, "function", no_cuda)
    rng = np.random.default_rng(5)
    Q, P, S, Hp, C, R, max_q = 4, 2, 4, 64, 16, 3, 50
    args = [_t(a) for a in _select_case(rng, "random", Q, P, S, Hp, C, R,
                                        max_q)]
    kw = dict(C=C, R=R, Hp=Hp, S=S, max_q=max_q, dpp=DPP)
    counts = (tpk.select_full_cuda.launches, tpk.claim_select_cuda.launches)
    sel, qs = tpk.select_full(*args, **kw)
    sel_p, qs_p = tpk.select_full_plain(*args, **kw)
    assert torch.equal(qs, qs_p)
    slot_col, prog = args[0], args[1]
    chunk_q, off_q, real_q = sel[4], sel[5] % C, args[7] >= 0
    hit, found = tpk.claim_select(slot_col, prog, chunk_q, off_q, real_q,
                                  C=C, dpp=DPP)
    assert torch.equal(hit, sel[0])
    assert counts == (tpk.select_full_cuda.launches,
                      tpk.claim_select_cuda.launches)
    with pytest.raises(ValueError):
        tpk.select_full_cuda(*args, **kw)
    with pytest.raises(ValueError):
        tpk.claim_select_cuda(slot_col, prog, chunk_q, off_q, real_q, C=C,
                              dpp=DPP)


def test_shared_memory_plan_is_refused_beyond_the_limit():
    """K3 and K4 share one plan (select_smem_bytes): one window of rounds
    (two 16-byte records and 16 16-bit candidates a round), the claimed
    bitmap and found counts, so Q does not enter it. The SIFT1M shape, the
    5M and 7M pins' Hp = 14,336 at S = 156 and 216 (whose whole budgets,
    max_query_num 7,072 and 8,591 a partition, one call may take) and Hp =
    2^16 fit under the default 48 KiB; S = 8,192 takes it past 48 KiB,
    opted in up to the card's limit (232,448 B on an H100); a plan beyond
    the limit, or Hp past the 16-bit slot indices, raises before any
    launch, naming Hp, S and the bytes. Every shape K4's own plan took
    before (up to Hp of about 46,400 at S = 124) still fits."""
    h100 = 232_448
    for what in ("claim_select", "select_full"):
        for Hp, S in ((3584, 124), (14_336, 156), (14_336, 216),
                      (1 << 16, 216)):
            tpk._check_smem(Hp, S, what, 48 * 1024)
        tpk._check_smem(46_400, 124, what, h100)
        tpk._check_smem(1024, 8192, what, h100)
        with pytest.raises(ValueError,
                           match=rf"{what}: .*261952 B .*Hp=3584, S=60000"):
            tpk._check_smem(3584, 60_000, what, h100)
        with pytest.raises(ValueError, match=r"Hp=65537 slots exceed"):
            tpk._check_smem((1 << 16) + 1, 124, what, h100)
    assert tpk.select_smem_bytes(3584, 124) == (
        256 * 64 + 112 * 4 + 124 * 4 + 2 * 16 * 160)
    assert tpk.select_smem_bytes(14_336, 216) <= 48 * 1024
    assert 48 * 1024 < tpk.select_smem_bytes(1024, 8192) <= h100
    assert not hasattr(tpk, "smem_bytes")
