"""Device-resident batch-PIR engine in PyTorch: the port of the JAX
package's pir/device_engine.py (DevicePianoEngine).

The whole client+server state lives on one device:

  offline (preprocessing):
    1. per-partition PRF offset tables — kernel K1 (ops/aes.py);
    2. one gather-XOR pass builds every primary+backup parity
       (pir.go:303-352) — kernel K2 (ops/xor_scan.py);
    3. replacement values gathered from the DB (pir.go:345-349) and the
       slot-column cache (PRF column of every primary slot).
    A table-free engine then drops the (P, T, S) table and keeps the
    partitions' AES round keys instead (the reference's client storage
    model, pir.go:404-427).

  online (DevicePianoEngine._round_on, one call per round of a batch):
    A. slot selection: the hit scan (pir.go:404-419) with in-batch
       reservations, then budgets. The client-protocol route picks the
       form: "xla" an owner fixpoint of torch ops, "pallas" kernel K4 for
       the claim, "fused" kernel K3 for the whole selection
       (ops/protocol_kernels.py); all three give the same outcome. Unless
       a route is named, a CUDA device takes "fused" wherever K3 can
       serve the round and "xla" elsewhere (resolve_route, once an
       engine);
    B. the query sets (the client->server message, pir.go:443-448), the
       server's one gather-XOR (pir.go:65-88, kernel K2), the unmask. A
       table-free engine evaluates the hit slots' offset sets and the
       refreshed slots' columns with the PRF (kernel K5) instead of
       reading them from the table;
    C. the hint refresh (pir.go:460-468) as row scatters.

The DB and the state are reached only through a few methods (_pack_db,
_prep_state, _dummy_state, _round, consumed, prepared, and the server
scan _scan), which the sharded engines override (pir/sharded_engine.py);
query() and the fused search run over any of them.

Protocol semantics, tie orders and the numpy draw order are the JAX
engine's, so the same seed gives the same state bit for bit (the tests
hold the two engines against each other). Differences of form only:
u32 arrays are int32 tensors with the same bits (utils/u32.py), offsets
are stored as int32 (the JAX engine narrows them to u16), and the state is
updated in place where JAX donated and rebuilt it.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from pacmann_tpu_torch import native_lib
from pacmann_tpu_torch.ops import aes, protocol_kernels, xor_scan
from pacmann_tpu_torch.pir import layout
from pacmann_tpu_torch.pir.params import (
    DEFAULT_PROGRAM_POINT,
    QUERY_PER_PARTITION,
    derive_batch_params,
    derive_piano_params,
)
from pacmann_tpu_torch.utils import cuda_lib, trace
from pacmann_tpu_torch.utils.u32 import first_true, from_u32, to_u32, u32_view

# Phase-C refresh form: row scatters up to this many update rows per
# round, the dense rewrite above it (the JAX engine's threshold; both
# forms give identical state).
_SCATTER_REFRESH_ROWS = 8192


def _resolve_refresh(rows: int) -> str:
    """The refresh form of a round of `rows` = Q*P update rows, as the JAX
    engine resolves it: $PACMANN_REFRESH_ROUTE "auto" (the default) takes
    the scatter up to _SCATTER_REFRESH_ROWS rows and the dense rewrite
    above, "scatter" the scatter, any other value the dense rewrite."""
    choice = os.environ.get("PACMANN_REFRESH_ROUTE", "auto")
    if choice == "auto":
        return "scatter" if rows <= _SCATTER_REFRESH_ROWS else "dense"
    return "scatter" if choice == "scatter" else "dense"


# Client-protocol routes, named as in the JAX engine: "xla" the owner
# fixpoint of torch ops, "pallas" kernel K4 for the claim, "fused" kernel
# K3 for the whole selection. "auto" is "pallas" on a CUDA device and "xla"
# on the CPU, as the JAX engine's is the Pallas kernel on a TPU and XLA
# elsewhere. None defers to $PACMANN_PROTOCOL_ROUTE, then to the default
# (resolve_route): "fused" on a CUDA device wherever K3 can serve the
# round, else _DEFAULT_ROUTE, which is the JAX engine's default everywhere.
ROUTES = ("xla", "pallas", "fused")
_DEFAULT_ROUTE = "xla"

# The state of the table engine; a table-free engine holds the partitions'
# AES round keys "rk" (P, 11, 16) uint8 in place of the offset "table".
STATE_KEYS = ("table", "slot_col", "tag", "prog", "primary_parity",
              "backup_parity", "hist", "finished", "repl_idx", "repl_val")
TABLE_FREE_STATE_KEYS = ("rk",) + STATE_KEYS[1:]


def _gather_repl(db4, repl_off, k: int):
    """Replacement values: db4 (S, P, C*k, 128), repl_off (P, S, R) local
    in-chunk offsets -> (P, S, R, k*128)."""
    S, P = db4.shape[:2]
    R = repl_off.shape[2]
    dev = db4.device
    rows = (repl_off.permute(1, 0, 2).long()[..., None] * k
            + torch.arange(k, device=dev)).reshape(S, P, R * k)
    g = db4[torch.arange(S, device=dev)[:, None, None],
            torch.arange(P, device=dev)[None, :, None], rows]
    return g.reshape(S, P, R, k * 128).permute(1, 0, 2, 3).contiguous()


def _build_skip(P: int, T: int, Hp: int, R: int, S: int, device):
    """(P, T, S) bool: backup-hint group g skips chunk g (pir.go:330-339)."""
    t = torch.arange(T, device=device)[:, None]
    s = torch.arange(S, device=device)[None, :]
    skip = (t >= Hp) & (s == torch.div(t - Hp, R, rounding_mode="floor"))
    return skip[None].expand(P, T, S)


def _consumed(st: dict, site: str | None = None) -> int:
    """Max over the state's partitions of the served count and of the
    backup-hint burn: two reads of the device, counted under sync counter
    `site` where one is given."""
    if site is not None:
        trace.count(site, 2)
    return max(int(st["finished"].max()), int(st["hist"].sum(dim=1).max()))


def resolve_route(route: str | None, device, *, Hp: int | None = None,
                  S: int | None = None, table: bool = True) -> str:
    """The client-protocol route of a round on `device` (see ROUTES):
    `route`, else $PACMANN_PROTOCOL_ROUTE, else the default. The default is
    "fused" on a CUDA device where kernel K3 can serve a round over Hp
    primary slots and S chunks from the offset table (table=False: a
    table-free client, which K3 cannot serve); everywhere else, and where
    Hp and S are not given, it is "xla". Reads no device: the shared-memory
    limit is read once a card (protocol_kernels.smem_limit)."""
    if route is None:
        route = os.environ.get("PACMANN_PROTOCOL_ROUTE")
    if route is None:
        dev = torch.device(device)
        if dev.type == "cuda" and table and Hp is not None:
            index = (torch.cuda.current_device() if dev.index is None
                     else dev.index)
            if protocol_kernels.select_fits(
                    Hp, S, protocol_kernels.smem_limit(index)):
                return "fused"
        return _DEFAULT_ROUTE
    if route == "auto":
        return "pallas" if torch.device(device).type == "cuda" else "xla"
    if route not in ROUTES:
        raise ValueError(f"unknown protocol route {route!r}; expected one "
                         f"of {ROUTES} or 'auto'")
    return route


def _pir_select(table, repl_idx, carry, idx_q, rnd_q, *, C, R, Hp, S,
                max_q, dpp, route, rk=None):
    """Client phases A + B-prep: slot selection and the query sets.

    Returns (sel, qs), qs (Q, P, S) int32 being the per-round offset
    vectors (the client->server message, pir.go:443-448); sel carries what
    _pir_finish needs. route: one of ROUTES, as resolve_route resolved it
    for the engine; every route gives the same hit, ok_q, ok_r, ig and qs.
    A round whose selection K3 (its plain version on the CPU) serves counts
    one select.fused.

    rk: the partitions' AES round keys (P, 11, 16) uint8. When given, the
    client is table-free: one PRF call (kernel K5 on CUDA) evaluates the
    hit slots' offset sets and the refreshed slots' columns, `table` is
    ignored, and route "fused" takes the owner fixpoint, as in the JAX
    engine (its K3 reads the table)."""
    tag, prog, ppar, slot_col, hist, finished = carry
    Q, P = idx_q.shape
    dev = idx_q.device
    if route == "fused" and rk is None:
        trace.count("select.fused")
        with trace.span("round.claim"):
            sel, qs = protocol_kernels.select_full(
                slot_col, prog, tag, table, repl_idx, hist, finished, idx_q,
                rnd_q, C=C, R=R, Hp=Hp, S=S, max_q=max_q, dpp=dpp)
        return (*sel, None), qs

    real_q = idx_q >= 0
    idxu_q = torch.where(real_q, idx_q, 0)
    chunk_q = torch.div(idxu_q, C, rounding_mode="floor")      # (Q, P)
    off_q = idxu_q % C

    # ---- Phase A: slot selection
    p_ix2 = torch.arange(P, device=dev)[None, :].expand(Q, P)
    with trace.span("round.claim"):
        if route == "pallas":
            hit_q, found = protocol_kernels.claim_select(
                slot_col, prog, chunk_q, off_q, real_q, C=C, dpp=dpp)
        else:
            hit_q, found = _claim_fixpoint(slot_col, prog, chunk_q, off_q,
                                           real_q, C=C, dpp=dpp)

    # ---- budgets, assigned by round order
    s_ar = torch.arange(S, device=dev)
    chunk_oh = found[..., None] & (chunk_q[..., None] == s_ar)
    rank_c = torch.cumsum(chunk_oh, dim=0) - 1                  # (Q, P, S)
    rank_own = torch.gather(rank_c, 2, chunk_q.long()[..., None])[..., 0]
    hist_own = hist[p_ix2, chunk_q]
    ig_q = hist_own + rank_own
    ok_r = found & (ig_q < R)
    rank_p = torch.cumsum(ok_r, dim=0) - 1
    ok_q = ok_r & (rank_p < (max_q - finished)[None, :])
    ig_q = torch.clamp(ig_q, max=R - 1)

    # ---- Phase B-prep: the query sets
    p_ix = torch.arange(P, device=dev)[None, :]
    hit_tag = tag[p_ix, hit_q]                                  # (Q, P)
    if rk is None:
        qs = table[p_ix, hit_tag]                               # (Q, P, S)
        new_col = None
    else:
        # both (Q, P, S) sheets the table would give, in one PRF call:
        # tags laid out [p, {hit tag, consumed backup tag}, q, s], x = s
        btag = Hp + chunk_q * R + ig_q
        tags = torch.stack([hit_tag.to(torch.int32), btag.to(torch.int32)])
        tags = tags.permute(2, 0, 1)[..., None].expand(P, 2, Q, S)
        xs = torch.arange(S, dtype=torch.int32, device=dev).expand(P, 2, Q, S)
        vals = aes.prf_eval(rk, tags.reshape(P, 2 * Q * S),
                            xs.reshape(P, 2 * Q * S), C - 1)
        vals = vals.reshape(P, 2, Q, S)
        qs = vals[:, 0].transpose(0, 1)                         # (Q, P, S)
        new_col = vals[:, 1].transpose(0, 1)                    # (Q, P, S)
    hp = prog[p_ix, hit_q]
    hp_set = hp != dpp
    s_iota = s_ar[None, None, :]
    qs = torch.where(
        (s_iota == torch.div(hp, C, rounding_mode="floor")[..., None])
        & hp_set[..., None], (hp % C)[..., None], qs)
    r_idx = repl_idx[p_ix, chunk_q, ig_q]                       # (Q, P)
    qs = torch.where(s_iota == chunk_q[..., None], (r_idx % C)[..., None], qs)
    # dummies keep the fixed access pattern (pir.go:363-371)
    qs = torch.where(ok_q[..., None], qs, rnd_q)

    sel = (hit_q, ok_q, ok_r, ig_q, chunk_q, idxu_q, new_col)
    return sel, qs.to(torch.int32)


def _claim_fixpoint(slot_col, prog, chunk_q, off_q, real_q, *, C, dpp):
    """Phase A of the "xla" route: the sequential greedy claim as an owner
    fixpoint (see the JAX engine). Round q's candidate is its first
    eligible slot not owned by an earlier round, owner[slot] the earliest
    round naming it; iterate until no owner changes (at most Q+1 passes,
    typically 2-3). The fixpoint is the reference's round-by-round outcome
    (pir.go:404-419). Returns (hit (Q, P), found (Q, P))."""
    Q, P = chunk_q.shape
    Hp = prog.shape[1]
    dev = chunk_q.device
    p_ix2 = torch.arange(P, device=dev)[None, :].expand(Q, P)
    prog_set = prog != dpp                                      # (P, Hp)
    prog_chunk = torch.div(prog, C, rounding_mode="floor")
    col_all = slot_col[p_ix2, chunk_q]                          # (Q, P, Hp)
    elig = (col_all == off_q[..., None]) & (
        ~prog_set[None] | (prog_chunk[None] != chunk_q[..., None]))
    elig &= real_q[..., None]

    q_iota = torch.arange(Q, device=dev)[:, None, None]
    h_iota = torch.arange(Hp, device=dev)
    owner = torch.full((P, Hp), Q, dtype=torch.int64, device=dev)
    while True:
        elig_eff = elig & (owner[None] >= q_iota)
        cand = first_true(elig_eff, 2)                          # (Q, P)
        found = elig_eff.any(dim=2)
        match = found[:, :, None] & (cand[:, :, None] == h_iota)
        new_owner = torch.where(match.any(dim=0), first_true(match, 0), Q)
        trace.count("sync.claim")
        changed = bool((new_owner != owner).any())
        owner = new_owner
        if not changed:
            break
    return torch.where(found, cand, 0), found


def _masked(x, mask):
    """x[mask]: a boolean-mask read of the scatter refresh, whose size the
    host waits for (counter sync.refresh_mask, one a read)."""
    trace.count("sync.refresh_mask")
    return x[mask]


def _pir_finish(repl_val, bpar, table, carry, sel, resp, *, C, R, Hp, S,
                refresh=None):
    """Client unmask + Phase-C refresh given the server response resp
    (Q, P, k*128) int32 (pir.go:451-468). Writes the refreshed rows into
    the carry's tensors in place. refresh: "scatter" or "dense"; None
    reads $PACMANN_REFRESH_ROUTE (_resolve_refresh). A table-free
    selection carries the refreshed columns in sel; `table` is then
    ignored."""
    tag, prog, ppar, slot_col, hist, finished = carry
    hit_q, ok_q, ok_r, ig_q, chunk_q, idxu_q, free_col = sel
    Q, P = hit_q.shape
    dev = hit_q.device
    p_ix = torch.arange(P, device=dev)[None, :]

    r_val = repl_val[p_ix, chunk_q, ig_q]                       # (Q, P, Ep)
    par = ppar[p_ix, hit_q]
    entries = torch.where(ok_q[..., None], resp ^ r_val ^ par, 0)

    # ---- Phase C: refresh writes (slots unique per partition)
    btag = Hp + chunk_q * R + ig_q                              # (Q, P)
    new_par = bpar[p_ix, btag - Hp] ^ entries
    new_col = free_col if free_col is not None \
        else table[p_ix, btag]                                  # (Q, P, S)
    if refresh is None:
        refresh = _resolve_refresh(Q * P)
    if refresh == "scatter":
        # rows not served are left out (the JAX engine routes them to the
        # out-of-bounds index Hp, which its scatter drops)
        pg = _masked(p_ix.expand(Q, P), ok_q)
        h = _masked(hit_q, ok_q)
        ppar[pg, h] = _masked(new_par, ok_q)
        tag[pg, h] = _masked(btag, ok_q).to(tag.dtype)
        prog[pg, h] = _masked(idxu_q, ok_q).to(prog.dtype)
        slot_col[pg, :, h] = _masked(new_col, ok_q)
    elif refresh == "dense":
        # invert the mapping: for every primary slot (p, h), the round q
        # that refreshed it (at most one), then masked selects
        hit_v = torch.where(ok_q, hit_q, -1)
        m3 = hit_v[:, :, None] == torch.arange(Hp, device=dev)  # (Q, P, Hp)
        upd = m3.any(dim=0)                                     # (P, Hp)
        src = first_true(m3, 0)                                 # (P, Hp)
        p_grid = torch.arange(P, device=dev)[:, None].expand(P, Hp)
        ppar.copy_(torch.where(upd[..., None], new_par[src, p_grid], ppar))
        tag.copy_(torch.where(upd, btag[src, p_grid].to(tag.dtype), tag))
        prog.copy_(torch.where(upd, idxu_q[src, p_grid].to(prog.dtype),
                               prog))
        sc_new = new_col[src, p_grid].transpose(1, 2)           # (P, S, Hp)
        slot_col.copy_(torch.where(upd[:, None, :], sc_new, slot_col))
    else:
        raise ValueError(f"unknown refresh form {refresh!r}")
    # burn the group index of every admitted candidate (ok_r), including
    # rounds later denied by the global budget (spent-by-assignment)
    s_ar = torch.arange(S, device=dev)
    hist += (ok_r[..., None] & (chunk_q[..., None] == s_ar)).sum(
        dim=0, dtype=hist.dtype)
    finished += ok_q.sum(dim=0, dtype=finished.dtype)
    return carry, entries, ok_q


def pack_partitions(raw: torch.Tensor, lo_p: int, hi_p: int, *, S: int,
                    C: int, k: int, psize: int, device=None,
                    chunks: tuple[int, int] | None = None) -> torch.Tensor:
    """Partitions [lo_p, hi_p) of the (n, entry_u32) int32 rows -> their
    (S, hi_p - lo_p, C*k, 128) int32 set-major DB on `device` (None: raw's
    device): partition p holds rows [p*psize, (p+1)*psize), zero padded to
    its S*C entries of k*128 words. chunks = (s0, s1) packs only chunks
    [s0, s1) of each partition, an (s1 - s0, ...) DB. Each partition's rows
    are written straight into their chunk slots, so the DB is the only
    buffer of its size and only one partition's rows move to `device` at a
    time."""
    n, entry_u32 = raw.shape
    dev = raw.device if device is None else torch.device(device)
    s0, s1 = (0, S) if chunks is None else chunks
    x = torch.zeros((s1 - s0, hi_p - lo_p, C * k, 128), dtype=torch.int32,
                    device=dev)
    for j, p in enumerate(range(lo_p, hi_p)):
        lo = p * psize + s0 * C
        hi = min(p * psize + min(s1 * C, psize), n)
        if hi <= lo:
            continue
        rows = raw[lo:hi].to(dev)
        slots = x[:, j].view(s1 - s0, C, k * 128)
        full, rem = divmod(hi - lo, C)
        if full:
            slots[:full, :, :entry_u32] = rows[:full * C].view(
                full, C, entry_u32)
        if rem:
            slots[full, :rem, :entry_u32] = rows[full * C:]
    return x


def pack_db(raw: torch.Tensor, *, S: int, P: int, C: int, k: int,
            psize: int) -> torch.Tensor:
    """(n, entry_u32) int32 -> the whole (S, P, C*k, 128) int32 DB on raw's
    device (pack_partitions of all P partitions)."""
    return pack_partitions(raw, 0, P, S=S, C=C, k=k, psize=psize)


def prep_partitions(db4, rk, repl_off, *, Hp: int, R: int,
                    chunk_mask: int, k: int):
    """The offline pass over the partitions a DB holds: db4 (S, P, C*k, 128)
    int32, rk (P, 11, 16) uint8 round keys, repl_off (P, S, R) int32 local
    offsets, all on one device. One K1 launch (the PRF tables) and one K2
    launch (every parity) on CUDA; on the CPU the tables are the host
    tier's native AES-NI ones where native_lib is available (the JAX
    engine's CPU backends). Returns (table (P, T, S), parities
    (P, T, k*128), repl_val (P, S, R, k*128), slot_col (P, S, Hp))."""
    S, P = db4.shape[:2]
    T = Hp + S * R
    tables = aes.prf_tables_native if native_lib.host_route(db4.device) \
        else aes.prf_tables
    with trace.span("prep.k1"):
        table = tables(rk, T, S, chunk_mask)                    # (P, T, S)
    with trace.span("prep.k2"):
        skip = _build_skip(P, T, Hp, R, S, db4.device)
        parities = xor_scan.xor_hintgen(db4, table, skip, k)
    with trace.span("prep.repl"):
        repl_val = _gather_repl(db4, repl_off, k)
        slot_col = table[:, :Hp, :].transpose(1, 2).contiguous()
    return table, parities, repl_val, slot_col


def new_state(offsets, parities, repl_idx, repl_val, slot_col, *, Hp: int,
              table_free: bool) -> dict:
    """The state of the partitions `parities` holds (P of them), on its
    device. offsets: the (P, T, S) table, or a table-free engine's round
    keys (P, 11, 16) uint8 (then the state has TABLE_FREE_STATE_KEYS)."""
    P = parities.shape[0]
    S = slot_col.shape[1]
    dev = parities.device
    return dict(
        {"rk" if table_free else "table": offsets},
        # cached PRF column per primary slot (initial tags are 0..Hp-1)
        slot_col=slot_col,                                      # (P, S, Hp)
        tag=torch.arange(Hp, dtype=torch.int32, device=dev).repeat(P, 1),
        prog=torch.full((P, Hp), DEFAULT_PROGRAM_POINT, dtype=torch.int32,
                        device=dev),
        primary_parity=parities[:, :Hp, :],
        backup_parity=parities[:, Hp:, :],
        hist=torch.zeros((P, S), dtype=torch.int32, device=dev),
        finished=torch.zeros((P,), dtype=torch.int32, device=dev),
        repl_idx=repl_idx,
        repl_val=repl_val,
    )


class DevicePianoEngine:
    """Batch PIR with device-resident hint state (the JAX engine's
    query/preprocessing API). device: where the DB and state live; a CUDA
    device runs the kernels, the CPU their plain versions."""

    def __init__(self, db_size: int, entry_bytes: int, batch_size: int,
                 raw, failure_prob_log2: int, verbose: bool = False,
                 device: torch.device | str | None = None, packed_db=None,
                 kernel_route: str | None = None, measure_comm: bool = False,
                 table_free: bool = False):
        """raw: (db_size, entry_bytes/4) u32 numpy array or int32 tensor;
        packed_db: an already packed (S, P, C*k, 128) int32 tensor (raw is
        then ignored). The DB and state live on `device`; None means the
        packed_db's or the raw tensor's device, and "cuda" for a numpy raw
        (which raises where CUDA is not available: the CPU is taken only
        when asked for).

        kernel_route: the client-protocol route of every batch (ROUTES,
        "auto", or None for $PACMANN_PROTOCOL_ROUTE, then the default:
        "fused" on a CUDA device where K3 takes the state's shape and the
        engine keeps the table, else "xla"), resolved once, here, as
        resolve_route says; protocol_route names the route taken.

        measure_comm: split each of query()'s rounds at the protocol
        messages (_measured_scan), the offset upload and the entry download
        crossing the host as numpy buffers whose bytes are counted in
        uploaded_bytes / downloaded_bytes (pir.go:443-448's messages); the
        fused search's rounds stay unmeasured, as in the JAX engine.

        table_free: keep no (P, T, S) offset table after preprocessing;
        every batch evaluates the offsets it needs with the PRF (kernel K5
        on CUDA) from the partitions' round keys. The same answers and
        state as the table engine."""
        self.config = derive_batch_params(
            db_size, entry_bytes, batch_size, failure_prob_log2)
        c = self.config
        self.verbose = verbose
        P, psize = c.partition_num, c.partition_size
        self.params = derive_piano_params(psize, entry_bytes, failure_prob_log2)
        p = self.params
        self.k = layout.entry_rows(entry_bytes // 4)
        self.Ep = self.k * 128
        if packed_db is not None:
            want = (p.set_size, P, p.chunk_size * self.k, 128)
            if tuple(packed_db.shape) != want:
                raise ValueError(
                    f"packed_db shape {tuple(packed_db.shape)} != {want}")
            self.device = packed_db.device
        else:
            self.device = cuda_lib.default_device(raw, device)
        self.table_free = table_free
        self.kernel_route = kernel_route
        # an unknown name raises here, before the DB is packed
        self.protocol_route = resolve_route(
            kernel_route, self.device, Hp=p.primary_hint_num, S=p.set_size,
            table=not table_free)
        if packed_db is None and isinstance(raw, np.ndarray):
            # each partition's rows move to the device as it is packed
            raw = u32_view(raw.reshape(db_size, entry_bytes // 4))
        self.db = packed_db if packed_db is not None else self._pack_db(raw)
        self._drop_state()
        self.measure_comm = measure_comm
        self.uploaded_bytes = 0      # measured client->server message bytes
        self.downloaded_bytes = 0    # measured server->client message bytes
        self.cache: dict[int, np.ndarray] = {}
        self._rng = np.random.default_rng()
        # extra fixed-shape rounds per query() batch re-issuing unserved
        # fetches (FCFS drops + hint misses); see query()
        self.query_retries = 1

        # stats (batch-pir.go:44-53)
        self.finished_batch_num = 0
        self.queries_made_in_partition = 0
        self.support_batch_num = 0
        self.preprocessing_time = 0.0
        self.comm_cost_per_batch_offline = 0

    # -- the hooks a sharded engine overrides (pir/sharded_engine.py): every
    # read or write of the DB or the state outside them goes through them

    def _pack_partitions(self, raw: torch.Tensor, lo_p: int, hi_p: int,
                         device=None, chunks=None) -> torch.Tensor:
        """Partitions [lo_p, hi_p) of the raw int32 rows -> their
        (S, hi_p - lo_p, C*k, 128) DB on `device` (None: the engine's);
        chunks as pack_partitions takes it."""
        return pack_partitions(
            raw, lo_p, hi_p, S=self.params.set_size, C=self.params.chunk_size,
            k=self.k, psize=self.config.partition_size,
            device=self.device if device is None else device, chunks=chunks)

    def _pack_db(self, raw: torch.Tensor):
        return self._pack_partitions(raw, 0, self.config.partition_num)

    def _drop_state(self):
        self.state = None

    @property
    def prepared(self) -> bool:
        """Whether hint state is installed (after a prep or a dummy)."""
        return self.state is not None

    def _prep_on(self, db4, rk: torch.Tensor, repl_off: np.ndarray,
                 repl_idx: np.ndarray, device) -> dict:
        """The offline pass over the partitions db4 holds, on `device`: rk
        (P, 11, 16) uint8 round keys, repl_off / repl_idx (P, S, R) u32.
        Returns their state."""
        p = self.params
        with trace.span("prep.upload"):
            rk = rk.to(device)
            repl_off_t = from_u32(repl_off, device)
            repl_idx_t = from_u32(repl_idx, device)
        table, parities, repl_val, slot_col = prep_partitions(
            db4, rk, repl_off_t, Hp=p.primary_hint_num,
            R=p.max_query_per_chunk, chunk_mask=p.chunk_mask, k=self.k)
        # a table-free engine keeps the round keys instead, the reference's
        # client storage model: the online path re-derives the offsets
        offsets = rk if self.table_free else table
        del table
        with trace.span("prep.state"):
            return new_state(offsets, parities, repl_idx_t, repl_val,
                             slot_col, Hp=p.primary_hint_num,
                             table_free=self.table_free)

    def _prep_state(self, rk: torch.Tensor, repl_off: np.ndarray,
                    repl_idx: np.ndarray):
        """Run the offline pass and install its state (see _prep_on)."""
        self.state = self._prep_on(self.db, rk, repl_off, repl_idx,
                                   self.device)

    def _zero_state_on(self, P: int, rk, device) -> dict:
        """dummy_preprocessing's state of P partitions on `device`: every
        hint zero; rk a table-free engine's round keys (None: a zero
        table)."""
        p = self.params
        S, R, Hp = p.set_size, p.max_query_per_chunk, p.primary_hint_num
        T = Hp + S * R

        def zeros(*shape):
            return torch.zeros(shape, dtype=torch.int32, device=device)

        return new_state(zeros(P, T, S) if rk is None else rk,
                         zeros(P, T, self.Ep), zeros(P, S, R),
                         zeros(P, S, R, self.Ep), zeros(P, S, Hp), Hp=Hp,
                         table_free=rk is not None)

    def _dummy_state(self, rk):
        """Install dummy_preprocessing's zero state (rk: a table-free
        engine's round keys, else None)."""
        self.state = self._zero_state_on(
            self.config.partition_num,
            None if rk is None else rk.to(self.device), self.device)

    def _round(self, idx_q: torch.Tensor, rnd_q: torch.Tensor,
               refresh=None):
        """One device round: idx_q (Q, P) int32 local indices (-1 =
        dummy), rnd_q (Q, P, S) int32 dummy offsets, both on the engine's
        device. Updates the state in place; returns (entries (Q, P, k*128)
        int32, ok (Q, P) bool) on the engine's device."""
        with trace.span("round"):
            return self._round_on(self.db, self.state, idx_q, rnd_q,
                                  refresh)

    def _round_on(self, db4, st: dict, idx_q, rnd_q, refresh=None, *,
                  scan=None):
        """The one round of the protocol over the partitions db4 and st
        hold, on their device: selection on the engine's protocol route,
        the server's answer (`scan`, None: the _scan hook), unmask and
        refresh; st is updated in place. A table-free st holds round keys
        "rk" in place of the table (see _pir_select). Returns (entries
        (Q, P, k*128) int32, ok (Q, P) bool) of those partitions."""
        p = self.params
        kw = dict(C=p.chunk_size, R=p.max_query_per_chunk,
                  Hp=p.primary_hint_num, S=p.set_size)
        carry = (st["tag"], st["prog"], st["primary_parity"],
                 st["slot_col"], st["hist"], st["finished"])
        with trace.span("round.select"):
            sel, qs = _pir_select(
                st.get("table"), st["repl_idx"], carry, idx_q, rnd_q,
                max_q=p.max_query_num, dpp=DEFAULT_PROGRAM_POINT,
                route=self.protocol_route, rk=st.get("rk"), **kw)
        with trace.span("round.scan"):
            resp = (scan or self._scan)(db4, qs)
        with trace.span("round.finish"):
            _, entries, oks = _pir_finish(
                st["repl_val"], st["backup_parity"], st.get("table"), carry,
                sel, resp, refresh=refresh, **kw)
        return entries, oks

    def _scan(self, db4, qs):
        """The server's answer to the query sets qs (Q, P, S) int32: one
        gather-XOR of db4 (kernel K2 on CUDA) -> (Q, P, k*128) int32."""
        return xor_scan.xor_server_scan(db4, qs, self.k).reshape(
            *qs.shape[:2], self.Ep)

    def _measured_scan(self, db4, qs):
        """_scan split at the observable protocol messages, as the JAX
        engine measures them: the (Q, P, S) u32 offset upload and the
        (Q, P, entry) download cross the host as numpy buffers, their bytes
        counted in uploaded_bytes / downloaded_bytes (pir.go:443-448). The
        padded lanes beyond entry_u32 are structurally zero and not part of
        the message, matching the reference's DBEntrySize*8."""
        qs_msg = to_u32(qs)
        self.uploaded_bytes += qs_msg.nbytes
        resp = self._scan(db4, from_u32(qs_msg, qs.device))
        E = self.config.entry_bytes // 4
        resp_msg = to_u32(resp)[:, :, :E]
        self.downloaded_bytes += resp_msg.nbytes
        padded = np.zeros(resp.shape, np.uint32)
        padded[:, :, :E] = resp_msg
        return from_u32(padded, qs.device)

    def consumed(self, site: str | None = None) -> int:
        """Device-measured budget use since prep: max over partitions of
        the served count and of the backup-hint burn (its reads counted
        under sync counter `site`, if given)."""
        return _consumed(self.state, site)

    # -- offline -------------------------------------------------------------

    def _record_stats(self, prep_time: float):
        self.preprocessing_time = prep_time
        self.support_batch_num = self.params.max_query_num // QUERY_PER_PARTITION
        db_bytes = float(self.config.db_size) * self.config.entry_bytes
        self.comm_cost_per_batch_offline = int(db_bytes / self.support_batch_num)

    def preprocessing(self, rng: np.random.Generator | None = None):
        """One hint generation; preprocessing_time is the seconds of its
        "prep" span, which ends on a synchronize on the card."""
        with trace.timed("prep") as span:
            trace.count("preps")
            self.finished_batch_num = 0
            self.queries_made_in_partition = 0
            self.cache = {}
            # drop the spent window's buffers before building the new one
            self._drop_state()
            if rng is not None:
                self._rng = rng
            p = self.params
            P = self.config.partition_num
            S, R, C = p.set_size, p.max_query_per_chunk, p.chunk_size

            # the JAX engine's draw order: replacement offsets, then one
            # AES key per partition (pir.go:345-349)
            with trace.span("prep.draw"):
                repl_off = (self._rng.integers(
                    0, 2**32, size=(P, S, R), dtype=np.uint64)
                    & np.uint64(p.chunk_mask)).astype(np.uint32)
                repl_idx = repl_off + (
                    np.arange(S, dtype=np.uint32) * C)[None, :, None]
                keys16 = [self._rng.bytes(16) for _ in range(P)]
            with trace.span("prep.keys"):
                rk = aes.round_keys(keys16)
            self._prep_state(rk, repl_off, repl_idx)
            if self.device.type == "cuda":
                with trace.span("prep.sync"):
                    torch.cuda.synchronize(self.device)
        self._record_stats(span.seconds)

    def dummy_preprocessing(self, rng=None):
        """Benchmark mode: zeroed hint state, fixed access pattern online."""
        if rng is not None:
            self._rng = rng
        self.finished_batch_num = 0
        self.queries_made_in_partition = 0
        P = self.config.partition_num
        # a table-free engine draws its P keys after the zero state, as
        # the JAX engine does
        self._dummy_state(aes.round_keys([self._rng.bytes(16)
                                          for _ in range(P)])
                          if self.table_free else None)
        self.cache = {}
        self._record_stats(0.0)

    # -- online --------------------------------------------------------------

    def _online(self, idx_q: np.ndarray, rand_offs: np.ndarray,
                refresh=None):
        """One round (see _round) from numpy inputs: idx_q (Q, P) i32,
        rand_offs (Q, P, S) u32."""
        idx_t = torch.from_numpy(np.asarray(idx_q, np.int32)).to(self.device)
        return self._round(idx_t, from_u32(rand_offs, self.device), refresh)

    def query(self, ids, retries: int | None = None) -> np.ndarray:
        """Reference batch contract (batch-pir.go:170-248): FCFS quota of
        len(ids)/P per partition, dummy padding, overflow -> zeros; one
        device round serves the whole batch, plus `retries` (default
        self.query_retries = 1) fixed-shape rounds that re-issue what the
        first could not serve (FCFS drops, hint misses). Retry rounds run
        unconditionally (all-dummy when nothing is left), so the server
        sees a fixed pattern; retries=0 is the strict single-round
        contract. Budget use is read back from the device after the batch
        (max of served count and backup-hint burn), as in the JAX engine.

        Traced as the request span "query" (counter `queries`), holding
        "query.fill" (the dedup; each round's FCFS fill and dummy draws),
        each round's "round", "query.read" (the round's entries and ok to
        the host, spread into the responses and the cache; the answers
        assembled) and "query.budget" (the consumed() read and the re-prep
        decision; a re-prep's own "prep" span inside it). Counters:
        query.rounds (rounds run), query.unserved (ids answered with
        zeros), sync.query_read (one a device->host read)."""
        with trace.span("query"):
            trace.count("queries")
            return self._query(ids, retries)

    def _query(self, ids, retries: int | None) -> np.ndarray:
        c = self.config
        p = self.params
        ids = [int(i) for i in ids]
        P = c.partition_num
        quota = len(ids) // P
        if retries is None:
            retries = self.query_retries

        responses: dict[int, np.ndarray] = {}
        E = c.entry_bytes // 4
        rounds_run = 0
        if quota > 0:
            # distinct uncached ids in first-come order (an in-batch repeat
            # hits the reference's response cache, pir.go:381-383)
            with trace.span("query.fill"):
                want: list[int] = []
                seen: set[int] = set()
                for idx in ids:
                    if idx not in seen and idx not in self.cache:
                        want.append(idx)
                        seen.add(idx)
            for rnd in range(1 + max(retries, 0)):
                # public-state-only guard: skip a retry round only when
                # even its worst-case consumption cannot fit the window
                if rnd > 0 and (self.queries_made_in_partition
                                + (rnd + 1) * quota >= p.max_query_num - 2):
                    break
                with trace.span("query.fill"):
                    idx_q = np.full((quota, P), -1, np.int32)
                    gidx_q = np.full((quota, P), -1, np.int64)
                    filled = [0] * P
                    next_want: list[int] = []
                    for gidx in want:
                        i = gidx // c.partition_size
                        if filled[i] < quota:
                            idx_q[filled[i], i] = gidx - i * c.partition_size
                            gidx_q[filled[i], i] = gidx
                            filled[i] += 1
                        else:
                            next_want.append(gidx)   # FCFS overflow -> retry
                    rand_offs = (self._rng.integers(
                        0, 2**32, size=(quota, P, p.set_size),
                        dtype=np.uint64)
                        & np.uint64(p.chunk_mask)).astype(np.uint32)
                if self.measure_comm:
                    # query()'s rounds alone cross the host byte-counted
                    idx_t = torch.from_numpy(idx_q).to(self.device)
                    rnd_t = from_u32(rand_offs, self.device)
                    with trace.span("round"):
                        entries, oks = self._round_on(
                            self.db, self.state, idx_t, rnd_t,
                            scan=self._measured_scan)
                else:
                    entries, oks = self._online(idx_q, rand_offs)
                with trace.span("query.read"):
                    entries = entries[:, :, :E].cpu().numpy().view(np.uint32)
                    trace.count("sync.query_read")
                    oks = oks.cpu().numpy()
                    trace.count("sync.query_read")
                    failed: list[int] = []
                    for j in range(quota):
                        for i in range(P):
                            g = gidx_q[j, i]
                            if g < 0:
                                continue
                            if oks[j, i]:
                                responses[int(g)] = entries[j, i]
                                self.cache[int(g)] = entries[j, i]
                            else:
                                failed.append(int(g))  # miss / budget deny
                rounds_run += 1
                want = next_want + failed
        trace.count("query.rounds", rounds_run)

        with trace.span("query.read"):
            out = np.zeros((len(ids), E), np.uint32)
            unserved = 0
            for r, idx in enumerate(ids):
                if idx in responses:
                    out[r] = responses[idx]
                elif idx in self.cache:
                    out[r] = self.cache[idx]
                else:
                    unserved += 1
        trace.count("query.unserved", unserved)

        # budget bookkeeping + auto re-prep (batch-pir.go:239-245), with
        # the estimate corrected to the device-measured consumption
        with trace.span("query.budget"):
            if rounds_run:
                self.queries_made_in_partition = self.consumed(
                    site="sync.query_read")
            if self.queries_made_in_partition >= p.max_query_num - 2:
                if self.verbose:
                    print(f"Redo preprocessing after "
                          f"{self.finished_batch_num} batches")
                self.preprocessing()
            else:
                self.finished_batch_num += len(ids) // c.batch_size
        return out

    # -- accounting (batch-pir.go:250-276) -----------------------------------

    def local_storage_size(self) -> float:
        return self.params.local_storage_bytes() * self.config.partition_num

    def extra_storage_size(self) -> float:
        """Client memory beyond the reference model (pir.go:178-190), by
        the JAX engine's formula: the resident PRF offset table (P, T, S)
        and the hit-scan slot-column cache (P, S, Hp), counted at 2 bytes an
        offset while the chunk fits u16 (4 above), as the JAX engine stores
        them; a table-free engine counts the cache alone. The port holds
        offsets as int32 (utils/u32.py), so its resident bytes are twice
        this at every current scale."""
        p = self.params
        nbytes = 2 if p.chunk_size <= (1 << 16) else 4
        per_part = p.set_size * p.primary_hint_num * nbytes
        if not self.table_free:
            per_part += p.total_tags * p.set_size * nbytes
        return float(per_part * self.config.partition_num)

    def comm_cost_per_batch_online(self) -> int:
        return int(self.params.comm_cost_per_query_bytes()
                   * QUERY_PER_PARTITION * self.config.partition_num)
