"""Fused batch-PIR engine — all partitions in one pass over the DB: the
port of the JAX package's pir/engine.py (FusedBatchPianoPIR).

The protocol is SimpleBatchPianoPIR's per partition (the same parameter
derivation, per-partition keys, hints and budgets, the same lossy batch
contract; the clients are pir/piano.py's numpy state machines), but the
computation is fused:

  * The P partition DBs are stacked chunk-major into one (S, P, C*k, 128)
    int32 tensor on the engine's device, db4; `db` is its flat view
    (S, P*C*k, 128), the JAX engine's db_f, where a local offset `o` of
    partition `p` is the row block `p*C + o`.
  * Offline hint generation is one launch of kernel K1 for every
    partition's PRF table (the P round keys stacked) and one of kernel K7b
    (attic.xor_hintgen_pallas: db4, the (P, T, S) local tables and the
    (P, T, S) skip mask), which hintgen_form runs in its staged form at
    the SIFT1M deployment.
  * An online batch sends exactly quota rows per partition, in partition
    order, and no skip: one launch of kernel K2's server scan
    (xor_scan.xor_gather, whose gather_form takes the row-split form) on
    the (P, quota, S) local offsets.

Equal partition sizing: the DB is zero-padded so every partition has
ceil(n/P) entries and shares one parameter set. Queries never touch padding
(ids < n); replacement samples that land on padding read zeros, matching the
reference's padded-chunk semantics (pir.go:285-295).

device=None runs on CUDA (raising where it is not available);
device="cpu" takes the host tier where native_lib is available, as the
JAX engine's host scans do: native AES-NI tables and one native scan of
the flat DB with global offsets p*C + o, at prep and at each batch; else
the kernels' plain versions.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from pacmann_tpu_torch import native_lib
from pacmann_tpu_torch.ops import aes, attic, xor_scan
from pacmann_tpu_torch.pir import layout
from pacmann_tpu_torch.pir.device_engine import _build_skip, pack_db
from pacmann_tpu_torch.pir.params import (
    DEFAULT_VALUE,
    QUERY_PER_PARTITION,
    derive_batch_params,
    derive_piano_params,
)
from pacmann_tpu_torch.pir.piano import PianoClient, QueryError, scan_rows
from pacmann_tpu_torch.utils import cuda_lib
from pacmann_tpu_torch.utils.u32 import from_u32, to_u32


class FusedBatchPianoPIR:
    """Drop-in replacement for SimpleBatchPianoPIR with fused device compute."""

    def __init__(self, db_size: int, entry_bytes: int, batch_size: int,
                 raw: np.ndarray, failure_prob_log2: int,
                 device=None, verbose: bool = False):
        entry_u32 = entry_bytes // 4
        raw = raw.reshape(db_size, entry_u32)
        self.config = derive_batch_params(
            db_size, entry_bytes, batch_size, failure_prob_log2
        )
        c = self.config
        self.verbose = verbose
        self.device = cuda_lib.default_device(None, device)
        P, psize = c.partition_num, c.partition_size
        self.params = derive_piano_params(psize, entry_bytes, failure_prob_log2)
        p = self.params

        # zero-pad to equal partitions and stack chunk-major
        padded = np.zeros((P * psize, entry_u32), np.uint32)
        padded[:db_size] = raw
        self.raw = padded                      # (P*psize, E) host copy
        self.k = layout.entry_rows(entry_u32)
        S, C = p.set_size, p.chunk_size
        self.db4 = pack_db(from_u32(padded, self.device), S=S, P=P, C=C,
                           k=self.k, psize=psize)      # (S, P, C*k, 128)
        self.db = self.db4.view(S, P * C * self.k, 128)

        self.clients = [PianoClient(p, device=self.device) for _ in range(P)]

        # stats (batch-pir.go:44-53)
        self.finished_batch_num = 0
        self.queries_made_in_partition = 0
        self.support_batch_num = 0
        self.preprocessing_time = 0.0
        self.comm_cost_per_batch_offline = 0
        self._skip_prep = False

    # -- offline -------------------------------------------------------------

    def _record_stats(self, prep_time: float):
        self.preprocessing_time = prep_time
        self.support_batch_num = self.params.max_query_num // QUERY_PER_PARTITION
        db_bytes = float(self.config.db_size) * self.config.entry_bytes
        self.comm_cost_per_batch_offline = int(db_bytes / self.support_batch_num)

    def preprocessing(self, rng: np.random.Generator | None = None):
        self.finished_batch_num = 0
        self.queries_made_in_partition = 0
        self._skip_prep = False
        t0 = time.perf_counter()

        p = self.params
        c = self.config
        P = c.partition_num
        S, R, Hp = p.set_size, p.max_query_per_chunk, p.primary_hint_num
        T = Hp + S * R
        C = p.chunk_size

        # every client's key first; the PRF draws nothing, so evaluating
        # all P tables after the loop keeps the reference's draw order
        for cl in self.clients:
            cl.initialization(rng)
        rk = torch.from_numpy(np.stack([cl.rk for cl in self.clients]))
        # backup hint group g skips chunk g, in every partition
        skip = _build_skip(P, T, Hp, R, S, self.device)
        if native_lib.host_route(self.device):
            table = aes.prf_tables_native(rk, T, S, p.chunk_mask)
            parities = self._host_scan(table, skip)
        else:
            table = aes.prf_tables(rk.to(self.device), T, S, p.chunk_mask)
            parities = attic.xor_hintgen_pallas(self.db4, table, skip,
                                                self.k)
        parities = scan_rows(parities.reshape(P * T, -1),
                             p.entry_u32).reshape(P, T, p.entry_u32)
        offsets = to_u32(table)                 # (P, T, S)

        psize = c.partition_size
        for i, cl in enumerate(self.clients):
            st = cl.state
            st.offsets = offsets[i]
            part = parities[i]
            st.primary_parity = part[:Hp].copy()
            st.backup_parity = part[Hp:].reshape(S, R, p.entry_u32).copy()
            # replacements from the host raw copy (pir.go:345-349)
            offs = (cl._rng.integers(0, 2**32, size=(S, R), dtype=np.uint64)
                    & np.uint64(p.chunk_mask)).astype(np.uint32)
            st.repl_idx = offs + (np.arange(S, dtype=np.uint32) * C)[:, None]
            idx = st.repl_idx.astype(np.int64).reshape(-1)
            in_range = idx < psize
            vals = np.zeros((S * R, p.entry_u32), np.uint32)
            vals[in_range] = self.raw[i * psize + idx[in_range]]
            st.repl_val = vals.reshape(S, R, p.entry_u32)

        self._record_stats(time.perf_counter() - t0)

    def _host_scan(self, local: torch.Tensor,
                   skip: torch.Tensor | None = None) -> torch.Tensor:
        """The host tier's scan: (P, B, S) int32 local offsets (and skip)
        -> (P*B, k, 128) parities, one native scan of the flat DB with the
        global row blocks p*C + o (the JAX engine's _xor)."""
        P, B, S = local.shape
        base = torch.arange(P, dtype=torch.int32) * self.params.chunk_size
        glob = (local + base[:, None, None]).reshape(P * B, S)
        if skip is None:
            skip = torch.zeros(glob.shape, dtype=torch.bool)
        return xor_scan.xor_scan_native(self.db, glob, skip.reshape(P * B, S),
                                        self.k)

    def dummy_preprocessing(self, rng=None):
        for cl in self.clients:
            cl.initialization(rng)
            cl.skip_prep = True
        self._skip_prep = True
        self._record_stats(0.0)

    # -- online --------------------------------------------------------------

    def query(self, ids) -> np.ndarray:
        """Batched oblivious fetch with the reference's lossy FCFS contract
        (batch-pir.go:170-248): quota len(ids)/P per partition, dummy padding,
        overflow dropped to zeros — but ONE fused server scan per batch."""
        c = self.config
        p = self.params
        P = c.partition_num
        ids = [int(i) for i in ids]
        quota = len(ids) // P

        partition_queries: list[list[int]] = [[] for _ in range(P)]
        for idx in ids:
            partition_queries[idx // c.partition_size].append(idx)

        # phase 1: prepare every sub-query client-side. In-flight sub-queries
        # of one partition reserve their hint slot, replacement group, and
        # index (the sequential reference's per-query atomicity, pipelined).
        # Each partition sends exactly quota rows of local offsets.
        offsets_rows = []
        pending = []          # (partition, ctx, global idx) aligned with rows
        responses: dict[int, np.ndarray] = {}
        for i in range(P):
            pq = partition_queries[i]
            while len(pq) < quota:
                pq.append(DEFAULT_VALUE)
            cl = self.clients[i]
            used_slots: set[int] = set()
            pend_hist: dict[int, int] = {}
            in_flight_idx: set[int] = set()
            for j in range(quota):
                if pq[j] == DEFAULT_VALUE:
                    offsets_rows.append(cl.prepare_dummy())
                    pending.append(None)
                    continue
                gidx = pq[j]
                if gidx in in_flight_idx:
                    # duplicate of an in-flight query: the sequential
                    # reference serves it from cache (pir.go:381-383)
                    offsets_rows.append(cl.prepare_dummy())
                    pending.append(None)
                    continue
                try:
                    ctx, qset = cl.prepare_query(
                        gidx - i * c.partition_size,
                        exclude_slots=used_slots, pending_hist=pend_hist)
                except QueryError:
                    pending.append(None)          # -> zeros
                    offsets_rows.append(cl.prepare_dummy())
                    continue
                if ctx[0] == "cached":
                    responses[gidx] = ctx[1]
                    # keep the fixed access pattern: send a dummy row anyway
                    offsets_rows.append(cl.prepare_dummy())
                    pending.append(None)
                else:
                    _, _, chunk_id, _, hit = ctx
                    used_slots.add(hit)
                    pend_hist[chunk_id] = pend_hist.get(chunk_id, 0) + 1
                    in_flight_idx.add(gidx)
                    offsets_rows.append(qset)
                    pending.append((i, ctx, gidx))

        # phase 2: one fused server scan
        if offsets_rows:
            batch_off = from_u32(np.stack(offsets_rows).reshape(
                P, quota, p.set_size), self.device)
            if native_lib.host_route(self.device):
                out = self._host_scan(batch_off)
            else:
                out = xor_scan.xor_gather(self.db4, batch_off, self.k)
            answers = scan_rows(out.reshape(P * quota, -1), p.entry_u32)
        else:
            answers = np.zeros((0, p.entry_u32), np.uint32)

        # phase 3: unmask + hint refresh
        for row, item in enumerate(pending):
            if item is None:
                continue
            i, ctx, gidx = item
            responses[gidx] = self.clients[i].finish_query(ctx, answers[row])

        entry_u32 = c.entry_bytes // 4
        out = np.zeros((len(ids), entry_u32), np.uint32)
        for r, idx in enumerate(ids):
            if idx in responses:
                out[r] = responses[idx]

        # budget bookkeeping + auto re-prep (batch-pir.go:239-245)
        if self.queries_made_in_partition >= p.max_query_num - 2:
            if self.verbose:
                print(f"Redo preprocessing after {self.finished_batch_num} batches")
            self.preprocessing()
        else:
            self.finished_batch_num += len(ids) // c.batch_size
            self.queries_made_in_partition += quota

        return out

    # -- accounting (batch-pir.go:250-276) -----------------------------------

    def local_storage_size(self) -> float:
        return self.params.local_storage_bytes() * self.config.partition_num

    def extra_storage_size(self) -> float:
        """Resident PRF offset tables beyond the reference storage model."""
        return float(sum(cl.offset_table_bytes() for cl in self.clients))

    def comm_cost_per_batch_online(self) -> int:
        return int(self.params.comm_cost_per_query_bytes()
                   * QUERY_PER_PARTITION * self.config.partition_num)
