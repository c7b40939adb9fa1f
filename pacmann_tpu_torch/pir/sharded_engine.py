"""Multi-device batch PIR: the port of the JAX package's
pir/sharded_engine.py (ShardedPianoEngine, ChunkShardedPianoEngine).

One process drives every shard of a mesh (parallel/sharding.py), as the
reference's single-controller shard_map does; a mesh may name one device
several times, so these engines also run as logical shards on one card.
Both reach the DB and the state only through DevicePianoEngine's hooks
(_pack_db, _prep_state, _dummy_state, _round, consumed, _scan), so
query(), the budget accounting and the fused private search run over them
unchanged.

ShardedPianoEngine shards the partition axis of everything: each shard
holds P / n_dev partitions' DB (S, P_loc, C*k, 128) and state, packed
straight from the raw rows, so no device and no host buffer ever holds
more than one shard of either (batch-pir.go:130-148's independent
partitions). Prep draws as the single engine does, globally, then each
shard runs K1, K2 and the replacement gather on its partitions; a batch
round runs the engine's round (_round_on) on each shard's columns with no
collective, and the entries are gathered.

ChunkShardedPianoEngine shards the chunk axis S of the DB (meshes with
more devices than partitions): each shard evaluates the offset columns of
its chunks with the per-point PRF (K5), scans its chunks into partial
parities (K2), and the XOR all-reduce combines them. Online it overrides
the server scan alone: the client phases (select, finish) run once, on
the mesh's first device, where the reference runs them replicated on
every device (the same values). Its state equals the single engine's bit
for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from pacmann_tpu_torch.ops import aes, xor_scan
from pacmann_tpu_torch.parallel.sharding import Mesh, xor_allreduce
from pacmann_tpu_torch.pir.device_engine import (
    DevicePianoEngine,
    _build_skip,
    _consumed,
    _gather_repl,
    new_state,
)
from pacmann_tpu_torch.utils import trace
from pacmann_tpu_torch.utils.u32 import from_u32


class ShardedPianoEngine(DevicePianoEngine):
    """DevicePianoEngine with the partition axis sharded over a mesh.

    db: the per-shard DBs, shard d on mesh.devices[d] holding partitions
    partition_ranges[d]; shard_states: their states. `state` is a gathered
    read-only copy of the whole state (for tests and inspection); nothing
    writes through it. Answers, state and budget equal the single engine's
    from the same seeds."""

    def __init__(self, db_size: int, entry_bytes: int, batch_size: int,
                 raw, failure_prob_log2: int, mesh: Mesh,
                 verbose: bool = False, table_free: bool = False,
                 kernel_route: str | None = None):
        self.mesh = mesh
        super().__init__(db_size, entry_bytes, batch_size, raw,
                         failure_prob_log2, verbose=verbose,
                         device=mesh.devices[0], kernel_route=kernel_route,
                         table_free=table_free)

    def _pack_db(self, raw: torch.Tensor) -> list:
        """Each shard packs only its own partitions, straight from the raw
        rows, on its device."""
        P, n_dev = self.config.partition_num, self.mesh.size
        if P % n_dev:
            raise ValueError(f"partition sharding needs the partitions "
                             f"divisible by the mesh: P={P}, "
                             f"devices={n_dev}")
        per = P // n_dev
        self.partition_ranges = [(d * per, (d + 1) * per)
                                 for d in range(n_dev)]
        return [self._pack_partitions(raw, lo, hi, dev)
                for (lo, hi), dev in zip(self.partition_ranges,
                                         self.mesh.devices)]

    def _drop_state(self):
        self.shard_states = None

    @property
    def prepared(self) -> bool:
        return self.shard_states is not None

    @property
    def state(self) -> dict | None:
        """The whole state, gathered onto the first device: a copy."""
        if self.shard_states is None:
            return None
        return {key: torch.cat([st[key].to(self.device)
                                for st in self.shard_states])
                for key in self.shard_states[0]}

    def _prep_state(self, rk: torch.Tensor, repl_off: np.ndarray,
                    repl_idx: np.ndarray):
        """The global draws split by shard; each shard preps its own
        partitions (one K1 and one K2 launch a shard on CUDA)."""
        self.shard_states = [
            self._prep_on(db, rk[lo:hi], repl_off[lo:hi], repl_idx[lo:hi],
                          dev)
            for db, (lo, hi), dev in zip(self.db, self.partition_ranges,
                                         self.mesh.devices)]

    def _dummy_state(self, rk):
        self.shard_states = [
            self._zero_state_on(hi - lo,
                                None if rk is None else rk[lo:hi].to(dev),
                                dev)
            for (lo, hi), dev in zip(self.partition_ranges,
                                     self.mesh.devices)]

    def _round(self, idx_q: torch.Tensor, rnd_q: torch.Tensor,
               refresh=None):
        """_round_on on each shard's columns of idx_q and rnd_q, no
        collective; entries and oks gathered on the partition axis. The
        refresh form is each shard's own (its Q * P_loc rows), as under the
        reference's shard_map."""
        entries, oks = [], []
        with trace.span("round"):
            for db, st, (lo, hi), dev in zip(self.db, self.shard_states,
                                             self.partition_ranges,
                                             self.mesh.devices):
                e, o = self._round_on(
                    db, st, idx_q[:, lo:hi].contiguous().to(dev),
                    rnd_q[:, lo:hi].contiguous().to(dev), refresh)
                entries.append(e.to(self.device))
                oks.append(o.to(self.device))
            return torch.cat(entries, dim=1), torch.cat(oks, dim=1)

    def consumed(self, site: str | None = None) -> int:
        return max(_consumed(st, site) for st in self.shard_states)


class ChunkShardedPianoEngine(DevicePianoEngine):
    """DevicePianoEngine with the chunk axis S of the DB sharded over a
    mesh (for meshes with more devices than partitions). db: the per-shard
    (S / n_dev, P, C*k, 128) DBs, shard d on mesh.devices[d]; the client
    state lives whole on the mesh's first device. S must divide by the
    mesh."""

    def __init__(self, db_size: int, entry_bytes: int, batch_size: int,
                 raw, failure_prob_log2: int, mesh: Mesh,
                 verbose: bool = False, kernel_route: str | None = None):
        self.mesh = mesh
        super().__init__(db_size, entry_bytes, batch_size, raw,
                         failure_prob_log2, verbose=verbose,
                         device=mesh.devices[0], kernel_route=kernel_route)

    def _pack_db(self, raw: torch.Tensor) -> list:
        """Each shard packs its own chunks of every partition."""
        S, n_dev = self.params.set_size, self.mesh.size
        if S % n_dev:
            raise ValueError(f"chunk sharding needs SetSize divisible by "
                             f"the mesh: S={S}, devices={n_dev}")
        S_loc = S // n_dev
        self.chunk_ranges = [(d * S_loc, (d + 1) * S_loc)
                             for d in range(n_dev)]
        P = self.config.partition_num
        return [self._pack_partitions(raw, 0, P, dev, chunks=ch)
                for ch, dev in zip(self.chunk_ranges, self.mesh.devices)]

    def _prep_state(self, rk: torch.Tensor, repl_off: np.ndarray,
                    repl_idx: np.ndarray):
        """Each shard: its offset columns PRF(key_p, t, s) for s in its
        chunks (one K5 launch over T * S_loc points a partition, the
        reference's prf_eval_fused form), its partial parities (one K2
        launch) and its replacement values; then the XOR all-reduce of the
        partials and the gather of the columns and the values."""
        p = self.params
        P = self.config.partition_num
        S, R, Hp = p.set_size, p.max_query_per_chunk, p.primary_hint_num
        T = Hp + S * R
        partials, cols, repl_vals = [], [], []
        for db, (s0, s1), dev in zip(self.db, self.chunk_ranges,
                                     self.mesh.devices):
            S_loc = s1 - s0
            tags = torch.arange(T, dtype=torch.int32,
                                device=dev).repeat_interleave(S_loc)
            xs = torch.arange(s0, s1, dtype=torch.int32, device=dev).repeat(T)
            col = aes.prf_eval(rk.to(dev), tags.expand(P, -1).contiguous(),
                               xs.expand(P, -1).contiguous(),
                               p.chunk_mask).reshape(P, T, S_loc)
            skip = _build_skip(P, T, Hp, R, S, dev)[:, :, s0:s1]
            partials.append(xor_scan.xor_hintgen(db, col, skip, self.k))
            repl_vals.append(_gather_repl(
                db, from_u32(repl_off[:, s0:s1], dev), self.k))
            cols.append(col)
        home = self.device
        table = torch.cat([c.to(home) for c in cols], dim=2)     # (P, T, S)
        self.state = new_state(
            table, xor_allreduce(partials), from_u32(repl_idx, home),
            torch.cat([v.to(home) for v in repl_vals], dim=1),
            table[:, :Hp, :].transpose(1, 2).contiguous(), Hp=Hp,
            table_free=False)

    def _scan(self, db4, qs):
        """Each shard scans its chunks' columns of the query sets (one K2
        launch a shard); the XOR all-reduce combines the partial answers
        on the first device."""
        partials = [
            xor_scan.xor_server_scan(db, qs[:, :, s0:s1].to(dev), self.k)
            for db, (s0, s1), dev in zip(db4, self.chunk_ranges,
                                         self.mesh.devices)]
        return xor_allreduce(partials).reshape(*qs.shape[:2], self.Ep)
