"""The multi-device dry run: the port of the JAX package's
dryrun_multichip (__graft_entry__.py:88-218), check for check, on a mesh
of n_devices shards (make_mesh's devices: ["cpu"] * 8 on the CPU,
["cuda:0"] * 8 as eight logical shards on one card).

  1. the chunk-sharded XOR scan against a numpy scan of the same DB;
  2. the row-sharded L2 top-k, its shape and its ids against knn_search;
  3. ShardedPianoEngine: prep and one exact batch;
  4. ChunkShardedPianoEngine against the single engine: the same answers
     and state;
  5. the fused private search over a partition-sharded engine against the
     single engine: the same answers.

Each check raises RuntimeError when it fails.
"""

from __future__ import annotations

import numpy as np
import torch

from pacmann_tpu_torch.graph.recall import knn_search
from pacmann_tpu_torch.parallel.sharding import (
    make_mesh, replicate, shard_db, shard_rows, sharded_l2_topk,
    sharded_xor_scan)
from pacmann_tpu_torch.pir import layout
from pacmann_tpu_torch.pir.convert import state_to_numpy
from pacmann_tpu_torch.pir.device_engine import DevicePianoEngine
from pacmann_tpu_torch.pir.sharded_engine import (
    ChunkShardedPianoEngine, ShardedPianoEngine)
from pacmann_tpu_torch.private.fused_search import FusedPrivateSearch
from pacmann_tpu_torch.private.oracle import pack_vertex_db
from pacmann_tpu_torch.utils.u32 import from_u32, to_u32


def _check(cond, what: str):
    if not cond:
        raise RuntimeError(f"dryrun_multichip: {what}")


def _xor_scan_np(db: np.ndarray, offsets: np.ndarray, skip: np.ndarray,
                 k: int) -> np.ndarray:
    """numpy scan: db (S, C*k, 128) u32, offsets / skip (B, S) ->
    (B, k, 128) u32."""
    B, S = offsets.shape
    out = np.zeros((B, k, 128), np.uint32)
    for s in range(S):
        rows = db[s].reshape(-1, k, 128)[offsets[:, s]]
        out ^= np.where(skip[:, s, None, None], np.uint32(0), rows)
    return out


def dryrun_multichip(n_devices: int, devices=None) -> None:
    mesh = make_mesh(n_devices, devices=devices)
    dev = mesh.devices[0]
    rng = np.random.default_rng(0)

    # 1. a tiny PIR database: S chunks divisible by the mesh
    chunk_size, set_size, entry_u32 = 32, 4 * n_devices, 8
    raw = rng.integers(0, 2**32, size=(chunk_size * set_size, entry_u32),
                       dtype=np.uint32)
    k_rows = layout.entry_rows(entry_u32)
    packed = layout.pack_db(raw, chunk_size, set_size)
    B = 16
    offsets = rng.integers(0, chunk_size, size=(B, set_size),
                           dtype=np.uint32)
    skip = np.zeros((B, set_size), bool)
    parities = sharded_xor_scan(
        mesh, shard_db(mesh, from_u32(packed)),
        replicate(mesh, from_u32(offsets)),
        replicate(mesh, torch.from_numpy(skip)), k_rows)
    _check(np.array_equal(to_u32(parities),
                          _xor_scan_np(packed, offsets, skip, k_rows)),
           "sharded XOR mismatch")

    # 2. a tiny vector DB for the sharded distance pass
    N, D, K = 64 * n_devices, 32, 10
    vectors = torch.from_numpy(rng.random((N, D), dtype=np.float32))
    queries = torch.from_numpy(rng.random((8, D), dtype=np.float32))
    ids, dists = sharded_l2_topk(mesh, replicate(mesh, queries),
                                 shard_rows(mesh, vectors), K)
    _check(tuple(ids.shape) == (8, K) and tuple(dists.shape) == (8, K),
           "sharded top-k shape")
    want = knn_search(vectors.to(dev), queries.to(dev), K)[1]
    _check(torch.equal(ids, want), "sharded top-k ids differ from "
           "knn_search's")

    # 3. the partition-sharded PIR engine: prep + one exact batch
    n_pir = 2048
    raw2 = rng.integers(0, 2**32, size=(n_pir, 8), dtype=np.uint32)
    pir = ShardedPianoEngine(n_pir, 32, 2 * n_devices, raw2, 20, mesh)
    pir.preprocessing(rng=np.random.default_rng(1))
    psize = pir.config.partition_size
    ids2 = [int(i * psize + 5) for i in range(pir.config.partition_num)]
    out = pir.query(ids2)
    _check(np.array_equal(out, raw2[ids2]), "sharded PIR rows")

    # 4. the chunk-sharded engine (P < n_devices) against the single one
    n_ck, batch_ck = 4096, 4
    raw3 = rng.integers(0, 2**32, size=(n_ck, 8), dtype=np.uint32)
    ck = ChunkShardedPianoEngine(n_ck, 32, batch_ck, raw3, 20, mesh)
    ck.preprocessing(rng=np.random.default_rng(2))
    ck_single = DevicePianoEngine(n_ck, 32, batch_ck, raw3, 20, device=dev)
    ck_single.preprocessing(rng=np.random.default_rng(2))
    ids3 = [int(i) for i in rng.integers(0, n_ck, batch_ck)]
    ck._rng = np.random.default_rng(3)
    ck_single._rng = np.random.default_rng(3)
    _check(np.array_equal(ck.query(list(ids3)), ck_single.query(list(ids3))),
           "chunk-sharded PIR mismatch")
    a, b = state_to_numpy(ck.state), state_to_numpy(ck_single.state)
    for key in ("primary_parity", "tag", "prog", "finished"):
        _check(np.array_equal(a[key], b[key]), f"chunk-sharded state {key}")

    # 5. the fused private search over a partition-sharded engine: m =
    # 2 * n_devices gives n_devices partitions, one a shard
    nf, df, mf = 1024, 8, 2 * n_devices
    vecs = rng.random((nf, df), dtype=np.float32)
    graphf = rng.integers(0, nf, size=(nf, mf)).astype(np.int64)
    rawf = pack_vertex_db(vecs, graphf)
    q = np.random.default_rng(5).random((2, df), dtype=np.float32)

    def fused(engine):
        engine.preprocessing(rng=np.random.default_rng(7))
        sids = np.arange(32)
        fs = FusedPrivateSearch(engine, sids, vecs[sids], graphf[sids],
                                dim=df, m=mf, n=nf)
        fs.generator.manual_seed(3)
        return fs.search(q, k=5, max_step=4, parallel=2)

    out_single = fused(DevicePianoEngine(nf, 4 * (df + mf), mf, rawf, 8,
                                         device=dev))
    out_shard = fused(ShardedPianoEngine(nf, 4 * (df + mf), mf, rawf, 8,
                                         mesh))
    _check(np.array_equal(out_single, out_shard), "fused-over-mesh mismatch")
