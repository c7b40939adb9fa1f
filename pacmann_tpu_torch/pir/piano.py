"""PianoPIR core protocol, single partition: the port of the JAX package's
pir/piano.py (QueryError, PianoServer, ClientState, PianoClient, PianoPIR).

The client is the reference's numpy state machine, field for field and
draw for draw (pianopir/pir.go:91-471): the hint state is struct-of-arrays,
the offset table offsets[tag, chunk] is kept client-side so that the
online hit scan and set expansion are table lookups, and the response
cache lives on the host. Only the DB and the two passes over it are torch
tensors on the engine's device:

  * the PRF offset table (pir.go:318,336): aes.prf_tables on the client's
    AES round keys, kernel K1 on CUDA;
  * the XOR scans over the flat (S, C*k, 128) DB, offline hint generation
    (pir.go:303-352) and the online server answer (pir.go:65-88):
    attic.xor_scan_pallas, kernel K7c on CUDA, whose flat_form takes the
    staged form for hint generation and the row form for one query.

device=None puts the server's DB, and runs both passes, on CUDA (raising
where CUDA is not available); device="cpu" takes the host tier
(native_lib's AES-NI table and AVX2 scan, as the JAX package's host
paths do) where it is available, else the kernels' plain versions. The
JAX package's host/device size thresholds tune its TPU's fixed-size
bitsliced block and are not carried over: a card present runs the passes
however small. use_device_prep=False is the caller asking for
the PRF table on the CPU; the scan runs where the server's DB is, as the
reference's does on a device-resident server.
"""

from __future__ import annotations

import dataclasses
import secrets

import numpy as np
import torch

from pacmann_tpu_torch import native_lib
from pacmann_tpu_torch.ops import aes, aes_host, attic, xor_scan
from pacmann_tpu_torch.pir import layout
from pacmann_tpu_torch.pir.device_engine import _build_skip, pack_db
from pacmann_tpu_torch.pir.params import (
    DEFAULT_PROGRAM_POINT,
    PianoParams,
    derive_piano_params,
)
from pacmann_tpu_torch.utils import cuda_lib
from pacmann_tpu_torch.utils.u32 import from_u32, to_u32


class QueryError(Exception):
    """Protocol-level online failure (budget exhausted / no hit hint)."""


def scan_rows(out: torch.Tensor, entry_u32: int) -> np.ndarray:
    """(B, k, 128) or (B, k*128) int32 parities -> (B, entry_u32) u32 on
    the host, the padding columns left behind on the device."""
    rows = out.reshape(out.shape[0], -1)[:, :entry_u32]
    return to_u32(rows.contiguous())


def flat_scan(db: torch.Tensor, offsets, skip, k: int,
              entry_u32: int) -> np.ndarray:
    """XOR scan of the flat (S, C*k, 128) DB: (B, S) offsets (u32 numpy or
    int32 tensor) and skip -> (B, entry_u32) u32 parities. The host tier
    (native_lib.xor_scan) for a CPU DB where it is available, else
    attic.xor_scan_pallas (kernel K7c on CUDA, its plain version on the
    CPU)."""
    if native_lib.host_route(db.device):
        out = xor_scan.xor_scan_native(db, offsets, skip, k)
    else:
        out = attic.xor_scan_pallas(db, offsets, skip, k)
    return scan_rows(out, entry_u32)


class PianoServer:
    """Holds the chunk-major DB; answers offset-vector XOR queries.

    Equivalent of PianoPIRServer (pir.go:28-88). `raw` is (db_size,
    entry_u32) u32 and stays on the host; the DB is the (S, C*k, 128) int32
    tensor of pir/layout.py on `device` (None: CUDA)."""

    def __init__(self, params: PianoParams, raw: np.ndarray, device=None):
        assert raw.shape == (params.db_size, params.entry_u32), raw.shape
        self.params = params
        self.raw = raw
        self.k = layout.entry_rows(params.entry_u32)
        self.device = cuda_lib.default_device(None, device)
        S, C = params.set_size, params.chunk_size
        self.db = pack_db(from_u32(raw, self.device), S=S, P=1, C=C,
                          k=self.k, psize=params.db_size).view(
                              S, C * self.k, 128)

    def non_private_query(self, idx: int) -> np.ndarray:
        p = self.params
        if idx >= p.db_size:
            if idx < p.chunk_size * p.set_size:
                return np.zeros(p.entry_u32, np.uint32)  # padding (pir.go:50-53)
            raise QueryError(f"idx {idx} is out of range")
        return self.raw[idx]

    def private_query_batch(self, offsets, skip=None) -> np.ndarray:
        """offsets: (B, SetSize) u32 -> (B, entry_u32) u32 XOR answers."""
        offsets = np.asarray(offsets, np.uint32)
        if skip is None:
            skip = np.zeros(offsets.shape, bool)
        return flat_scan(self.db, offsets, skip, self.k,
                         self.params.entry_u32)

    def private_query(self, offsets: np.ndarray) -> np.ndarray:
        return self.private_query_batch(offsets[None])[0]


@dataclasses.dataclass
class ClientState:
    """Struct-of-arrays hint state (pir.go:91-122)."""

    primary_tag: np.ndarray        # (Hp,) u32 — tag held by each primary slot
    primary_parity: np.ndarray     # (Hp, E) u32
    primary_prog: np.ndarray       # (Hp,) u32, DEFAULT_PROGRAM_POINT = unset
    repl_idx: np.ndarray           # (S, R) u32 — global entry index
    repl_val: np.ndarray           # (S, R, E) u32
    backup_parity: np.ndarray      # (S, R, E) u32; tag of (c, j) = Hp + c*R + j
    histogram: np.ndarray          # (S,) u32 consumed per chunk
    finished: int                  # queries consumed
    offsets: np.ndarray            # (T, S) u32 — PRF(tag, chunk) & mask table


class PianoClient:
    """Stateful PianoPIR client (pir.go:91-471).

    device: where the PRF table is evaluated (None: CUDA); use_device_prep
    False evaluates it on the CPU instead, None and True on `device`."""

    def __init__(self, params: PianoParams,
                 use_device_prep: bool | None = None, device=None):
        self.params = params
        self.use_device_prep = use_device_prep
        self.device = cuda_lib.default_device(None, device)
        self.skip_prep = False
        self.state: ClientState | None = None
        self.cache: dict[int, np.ndarray] = {}
        self.key: bytes = b"\x00" * 16

    # -- offline ------------------------------------------------------------

    def initialization(self, rng: np.random.Generator | None = None):
        """Reset all hint state and resample the master key (pir.go:203-255)."""
        p = self.params
        rng = rng or np.random.default_rng(secrets.randbits(64))
        self.key = rng.bytes(16)
        self.rk = aes_host.expand_key(self.key)      # (11, 16) round keys
        E = p.entry_u32
        S, R, Hp = p.set_size, p.max_query_per_chunk, p.primary_hint_num
        self.state = ClientState(
            primary_tag=np.arange(Hp, dtype=np.uint32),
            primary_parity=np.zeros((Hp, E), np.uint32),
            primary_prog=np.full(Hp, DEFAULT_PROGRAM_POINT, np.uint32),
            repl_idx=np.full((S, R), DEFAULT_PROGRAM_POINT, np.uint32),
            repl_val=np.zeros((S, R, E), np.uint32),
            backup_parity=np.zeros((S, R, E), np.uint32),
            histogram=np.zeros(S, np.uint32),
            finished=0,
            offsets=np.zeros((Hp + S * R, S), np.uint32),
        )
        self.cache = {}
        self._rng = rng

    def preprocessing(self, server: PianoServer,
                      rng: np.random.Generator | None = None):
        """Generate all hints: PRF table pass + XOR-scan pass (pir.go:267-352)."""
        self.initialization(rng)
        if self.skip_prep:
            return
        p = self.params
        st = self.state
        S, R, Hp = p.set_size, p.max_query_per_chunk, p.primary_hint_num
        T = Hp + S * R

        # Pass 1: PRF offset table offsets[tag, chunk] (pir.go:318,336).
        table = self._offset_table(T, S)
        st.offsets = to_u32(table)

        # Pass 2: parities. Primary hints cover every chunk; backup hint group
        # c skips chunk c (pir.go:330-339).
        skip = _build_skip(1, T, Hp, R, S, table.device)[0]
        parities = self._xor_scan(server, table, skip)
        st.primary_parity = parities[:Hp].copy()
        st.backup_parity = parities[Hp:].reshape(S, R, p.entry_u32).copy()

        # Pass 3: replacements — random (idx, value) per chunk (pir.go:345-349).
        offs = (self._rng.integers(0, 2**32, size=(S, R), dtype=np.uint64)
                & np.uint64(p.chunk_mask)).astype(np.uint32)
        st.repl_idx = offs + (np.arange(S, dtype=np.uint32) * p.chunk_size)[:, None]
        # gather values from the host-resident raw DB; indices past db_size
        # are zero-padding rows (pir.go:285-295)
        idx = st.repl_idx.astype(np.int64).reshape(-1)
        in_range = idx < p.db_size
        vals = np.zeros((S * R, p.entry_u32), np.uint32)
        vals[in_range] = server.raw[idx[in_range]]
        st.repl_val = vals.reshape(S, R, p.entry_u32)

    def _prep_device(self) -> torch.device:
        return (torch.device("cpu") if self.use_device_prep is False
                else self.device)

    def _offset_table(self, T: int, S: int) -> torch.Tensor:
        """(T, S) int32 PRF(tag, chunk) & chunk_mask on the prep device:
        the host tier's table on the CPU where it is available."""
        dev = self._prep_device()
        rk = torch.from_numpy(self.rk[None].copy()).to(dev)
        tables = aes.prf_tables_native if native_lib.host_route(dev) \
            else aes.prf_tables
        return tables(rk, T, S, self.params.chunk_mask)[0]

    def _xor_scan(self, server: PianoServer, offsets, skip) -> np.ndarray:
        """(B, S) offsets and skip -> (B, entry_u32) parities, scanned on
        the server's device."""
        return flat_scan(server.db, offsets, skip, server.k,
                         self.params.entry_u32)

    # -- online -------------------------------------------------------------

    def _backup_tag(self, chunk: int, j: int) -> int:
        return self.params.primary_hint_num + chunk * self.params.max_query_per_chunk + j

    def prepare_dummy(self) -> np.ndarray:
        """Dummy query: SetSize random offsets (pir.go:363-371)."""
        p = self.params
        return (self._rng.integers(0, 2**32, size=p.set_size, dtype=np.uint64)
                & np.uint64(p.chunk_mask)).astype(np.uint32)

    def prepare_query(self, idx: int, exclude_slots=None, pending_hist=None):
        """Phase 1 of one online query (pir.go:354-446): hit scan, set
        expansion, replacement. Returns (ctx, query_set offsets (S,)) or
        (("cached", value), None). Raises QueryError on protocol failure.

        exclude_slots / pending_hist support batched pipelining (engine.py):
        slots and replacement groups already reserved by in-flight queries
        of the partition are not reused, as the sequential reference's
        atomic prepare+finish per query gives."""
        p = self.params
        st = self.state

        if idx >= p.db_size:
            raise QueryError(f"idx {idx} is out of range")
        if idx in self.cache:
            return ("cached", self.cache[idx]), None
        n_pending = sum(pending_hist.values()) if pending_hist else 0
        if st.finished + n_pending >= p.max_query_num:
            raise QueryError("exceed the maximum number of queries")

        chunk_id, offset = divmod(idx, p.chunk_size)
        in_flight = pending_hist.get(chunk_id, 0) if pending_hist else 0
        if st.histogram[chunk_id] + in_flight >= p.max_query_per_chunk:
            raise QueryError(f"too many queries in chunk {chunk_id}")

        # hit scan (pir.go:404-419): first primary slot whose PRF offset in
        # chunk_id equals offset and isn't already programmed in this chunk.
        col = st.offsets[st.primary_tag, chunk_id]
        eligible = (col == offset) & (
            (st.primary_prog == DEFAULT_PROGRAM_POINT)
            | (st.primary_prog // p.chunk_size != chunk_id)
        )
        if exclude_slots:
            eligible[list(exclude_slots)] = False
        hits = np.flatnonzero(eligible)
        if hits.size == 0:
            raise QueryError("no hit hint in the primary hint table")
        hit = int(hits[0])

        # expand to a full set (pir.go:422-427) — table row lookup
        query_set = st.offsets[st.primary_tag[hit]].copy()  # offsets per chunk
        # enforce programmed point (pir.go:430-433)
        prog = int(st.primary_prog[hit])
        if prog != DEFAULT_PROGRAM_POINT:
            query_set[prog // p.chunk_size] = prog % p.chunk_size
        # replacement for the queried chunk (pir.go:436-439); in-flight
        # queries in the same chunk have reserved earlier groups
        in_group = int(st.histogram[chunk_id]) + in_flight
        repl_idx = int(st.repl_idx[chunk_id, in_group])
        query_set[chunk_id] = repl_idx % p.chunk_size

        return ("live", idx, chunk_id, in_group, hit), query_set

    def finish_query(self, ctx, response: np.ndarray) -> np.ndarray:
        """Phase 2: un-mask the server answer and refresh the spent hint from
        a backup (pir.go:451-468)."""
        if ctx[0] == "cached":
            return ctx[1]
        _, idx, chunk_id, in_group, hit = ctx
        st = self.state
        repl_val = st.repl_val[chunk_id, in_group]

        # un-mask (pir.go:451-453)
        response = response ^ repl_val ^ st.primary_parity[hit]

        # refresh from backup (pir.go:460-463)
        st.primary_tag[hit] = self._backup_tag(chunk_id, in_group)
        st.primary_parity[hit] = st.backup_parity[chunk_id, in_group] ^ response
        st.primary_prog[hit] = idx

        st.finished += 1
        st.histogram[chunk_id] += 1
        self.cache[idx] = response
        return response

    def query(self, idx: int, server: PianoServer, real: bool = True) -> np.ndarray:
        """One online query (pir.go:354-471). Raises QueryError on protocol
        failure (budget exhausted / no hit hint), matching the reference's
        error returns; callers that want the zero-entry contract catch it."""
        if not real:
            server.private_query(self.prepare_dummy())
            return np.zeros(self.params.entry_u32, np.uint32)
        ctx, query_set = self.prepare_query(idx)
        if ctx[0] == "cached":
            return ctx[1]
        response = server.private_query(query_set)
        return self.finish_query(ctx, response)

    # -- accounting ---------------------------------------------------------

    def local_storage_bytes(self) -> float:
        return self.params.local_storage_bytes()

    def offset_table_bytes(self) -> int:
        """Extra client memory for the online PRF table (not in the reference
        model; see the module docstring)."""
        return int(self.state.offsets.size * 4) if self.state is not None else 0


class PianoPIR:
    """Client+server wrapper (pir.go:473-548). device: where the server's
    DB lives and the client's prep runs (None: CUDA; "cpu": the plain
    versions)."""

    def __init__(self, db_size: int, entry_bytes: int, raw: np.ndarray,
                 failure_prob_log2: int, device=None,
                 use_device_prep: bool | None = None):
        self.params = derive_piano_params(db_size, entry_bytes, failure_prob_log2)
        if raw.dtype != np.uint32:
            raise ValueError("raw DB must be uint32 (entry-major)")
        raw = raw.reshape(db_size, self.params.entry_u32)
        self.server = PianoServer(self.params, raw, device=device)
        self.client = PianoClient(self.params, use_device_prep=use_device_prep,
                                  device=self.server.device)

    def preprocessing(self, rng=None):
        self.client.preprocessing(self.server, rng=rng)

    def dummy_preprocessing(self, rng=None):
        self.client.initialization(rng)
        self.client.skip_prep = True

    def query(self, idx: int, real: bool = True) -> np.ndarray:
        # auto re-prep on exhaustion (pir.go:525-533)
        if self.client.state.finished == self.params.max_query_num:
            self.client.preprocessing(self.server)
        return self.client.query(idx, self.server, real)

    def local_storage_size(self) -> float:
        return self.params.local_storage_bytes()

    def comm_cost_per_query(self) -> float:
        return self.params.comm_cost_per_query_bytes()
