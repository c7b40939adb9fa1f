#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU (an H100).

Drives the port's main path (pacmann_tpu_torch) once, the way bench.py
drives the JAX package, at the reference's SIFT1M-shaped deployment:
n = 1,000,000 entries of 640 B (128 f32 || 32 u32), batch 32 (16
partitions), FailureProbLog2 = 8; then the plaintext search path at
SIFT1M's shape (1M integer-valued vectors of 128 dimensions, 1,000
queries). Phases, in order:

  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build kernels K1 and K5 (csrc/aes_mmo.cu), K2 and the attic's K7a-
     K7c (csrc/xor_gather.cu), K3/K4 (csrc/protocol.cu), K6
     (csrc/l2_distance.cu) and the attic's K7d (csrc/refresh_parity.cu),
     one nvcc each, all started together; fail if ptxas reports a spill
     in aes_mmo, xor_gather, protocol or l2_distance;
  3. each kernel against its plain torch version on the card at the main
     path's shapes, bit-equal, both timed with CUDA events, beside its
     bound (the least time the card could take for the same work): K1
     at the main prep shape (also spot-checked against the numpy AES
     oracle), at the 5M pin's prep shape (16, 35,552, 156) and on a ragged
     lattice (S = 300, T * S no multiple of a block, mask 1,000), also
     replayed from a CUDA graph; K5 (the table-free PRF) at Q = 6 and 96
     and against K1's table at the same points, also replayed from a CUDA
     graph beside an empty kernel of its Q = 6 launch shape (the launch
     floor), and on a ragged (3, 1,001) list with half its tags at or
     above 2^29; K3 (select_full) and K4 (claim_select), one claim pass,
     at Q = 6, 96 and 384 and at the private driver's quotas
     (private_quotas: 48 for its group-8 "device-fused" run) on uniform, contended, budget-edge and deep
     rounds (more than the kept candidates contend for one row, so the
     walk scans rows on; Q = 384 spans two windows), also replayed from a
     CUDA graph (uniform and deep), each case with the rounds that took a
     row scan in the walk; K4 on an edge input the engines never send
     (unreal rounds with any chunk and offset, real rounds with a chunk of
     -1 or S, offset -1 on rows holding a few -1s, Hp % 4 = 0 and 3); K3
     also at a synthetic S = 8,192 whose shared-memory plan passes 48 KiB
     (opted in, a cluster of 8);
     K2 (xor_gather) in each of its forms
     (chunk-major, row-split and sliced) at the prep, Q = 6, 96 and the
     private driver's quotas (48),
     at B = 16C - 1 and 16C (the two sides of gather_form's switch), at
     a ragged shape (S = 13, k = 3, B = 5,000, all-skip rows) and, row
     and sliced forms only (C above the chunk form's), at the 5M pin's
     prep (C = 2,048), the SIFT100M shard's (4, 179,584, 764), C =
     8,192, and on edge inputs at k = 1, 3 and 5 (compare_k2_sliced); K6
     (l2_distance) at 1,000 x 1M x 128, at the blocks the plaintext paths
     launch, at (1,000, 4,099) x D = 37 and on rows off 16-byte alignment,
     bit-equal on integer data and within 1e-5 (|q|^2 + |p|^2) on floats
     (its plain version is the cuBLAS form). The repair pins: K2 at k = 5 and 8
     (entries over 2 KiB) at the prep and Q = 96 shapes, and K3/K4 at
     (P, S, Hp) = (16, 216, 14,336) (n = 7M) at Q = 6, 96 and the pin's
     whole budget, max_query_num rounds a partition. The attic phase: one
     call of each attic entry point with the launch counters from zero
     (each K7 kernel launched, no other kernel), then each against its
     plain version,
     bit-equal and timed beside its bound: K7b (xor_hintgen_pallas) and
     K7a (xor_hintgen_mm_s8p, on to_plane_major_s8 of the DB, sc = 1 and
     4) on the engine's DB with K1's table and the skip mask, K7b in both
     forms (staged and row), each also replayed from a CUDA graph, and at
     k = 5, at B = 16C - 1 and 16C and on a ragged input (S = 13, B =
     5,000, all-skip rows, offsets outside [0, C) not skipped); K7c
     (xor_scan_pallas) on the flat single-server layout of 1M x 640 B
     (C = 2,048, S = 492, B = 57,632, skip 25 %); K7a and K7c in both
     forms (staged and row), beside the staged form's shared-memory floor,
     also K7a at k = 5, K7c at a ragged (1,000, 301, 9,001) and at B =
     2,000 (the row form's side of the rule), and both on offsets outside
     [0, C) that no skip covers; K7d (refresh_parity) at
     P = 16, Hp = 3,584, Ep = 256 for Q = 6, 96 and repeated hits. Then
     the CUDA engine +
     fused search against the same code on the CPU (plain versions) at a
     small size, bit-equal, on each protocol route ("xla", "pallas",
     "fused") and table-free on "xla" and "pallas", and the plaintext
     engine and search_paths_all the same way at n = 65,536; and those
     five PIR engines against each other at full size: the same answers
     and state (all but the table or the round keys) over ten batch-96
     batches; then the resident client state with and without the table;
  4. the main path, with the launch counters set to 0 just before each
     path and read just after: once per route with the table, then
     table-free on "xla" and "pallas": the engine (one warm and three timed
     preprocessing runs, then ten query batches of 96 ids; every answered
     row equals its raw row, success at least 0.98), and, except on the
     table engine's "pallas", fused private search, groups 1 and 16
     (max_step 20, parallel 3, k 10; fetch success within 0.03 of the
     analytic bound, params.expected_success_rate); then a table-free
     "pallas" engine in measure_comm mode: three batch-96 batches with the
     same answers and state as the unmeasured table engine, and message
     bytes equal to the analytic model; then the host-state engines
     (host_engines_phase): PianoPIR, SimpleBatchPianoPIR and
     FusedBatchPianoPIR, each on CUDA against the CPU at a small size, then
     each at full size with its own launch counts and the forms its
     wrappers picked: PianoPIR and SimpleBatchPianoPIR launch K1 and K7c
     (staged at prep, row per query) and FusedBatchPianoPIR K1, K7b
     (staged) and K2 (row-split), prep ms, ms per query or batch, every
     served row its raw row, success against the model; then the private
     driver (private_search_phase): run_private_search on every engine on
     CUDA against the CPU at n = 16,384 (the same answers, reach steps and
     success); the graph build (graph/build.py) and the cluster baseline
     (graph/cluster.py) on CUDA against the CPU at n = 16,384 on
     integer-valued vectors (each integer stage of the build replayed on
     the card from the CPU build's recorded inputs, bit-equal; the whole
     graph from the CPU's draws equal or its differing rows counted with
     their cause, and the card's own draws build the same graph; k-means
     labels, centroids and search ids equal given the same seeding ids);
     then at scripts/run-private-search.sh's deployment (1M x 640 B, k =
     10, step 20, parallel 3) on 1M manifold vectors of SIFT1M's shape
     (u8, 8 latent dimensions) in a .bvecs file and the graph the driver builds from it (no
     graph file, build_graph=True: build_graph's defaults, the gate on;
     the first run builds, caches it and writes the aux record, the later
     runs load it; every row m distinct non-self ids, gate hit rate at
     least 0.95; the build's phase times and peak memory printed); q cut
     to 2-100 a run: "device-fused" (route "fused", concurrent 8),
     "device" ("pallas"), "fused" (sequential, concurrent 8 and traced by
     -profile for the device's busy share), "simple" and non-private, each
     with its exact kernels (simple K1 + K7c; fused K1 + K7b + K2; device
     and device-fused K1 + K2 + K4 or K3; non-private its engine's prep
     only), success against the model or above 0.7, the report's fields;
     "device-fused" and "fused" recall@10 at least non-private recall -
     0.05 (100 queries each); the plaintext engine's recall@10 on the
     built graph at least 0.2 above a random graph's (1,000 queries,
     ground truth through K6); the cluster baseline on the same 1M vectors
     (sqrt(n) = 1,000 clusters, 10 Lloyd iterations: train s, ms/query,
     recall@10, K6 launches exact: one a seeding center, one a Lloyd block
     an iteration, one a block of 64 queries); the same build, plaintext
     recall and cluster baseline on 1M vectors of 12 latent dimensions
     (the harder workload; gate and recall bars from its own readings over
     several seeds, scripts/build_quality.py);
     cli.private_search.main once with -report and -profile (a trace
     naming K2); then the repair
     pins on the engine, each DB freed before the next: n = 1M entries of
     3,968 B (k = 8, 4.16 GB packed) on route "xla", and n = 5M entries of
     640 B
     (Hp = 14,336, 5.23 GB packed) on "pallas" and "fused" (one warm and
     one timed prep, three batch-96 batches, every answered row equal to
     its raw row, success at least 0.98); after the "fused" paths' counts,
     one more (untimed) batch-96 and fused group 16 and 1 ("fused") or
     batch ("5M fused") with the rounds that took a row scan in K3's walk
     counted; then the multi-device tier as four logical shards on
     the card (make_mesh(devices=["cuda:0"] * 4), "4 shards on 1
     device(s)"): ShardedPianoEngine on "xla", "pallas", "fused" and
     table-free "xla" and ChunkShardedPianoEngine (S_loc = 31) on "xla",
     each through a warm and a timed prep, three batch-96 batches and
     fused groups 1 and 16 against DevicePianoEngine from the same seeds
     (state bit-equal after each stage, the same answers and fetch
     counters, launches counted from zero and exactly four times the
     single engine's, the chunk engine's K5 for K1 and one select),
     sharded_l2_topk at 1,000 x 1M x 128 equal to knn_search,
     cli.exact_search -shards 4 at n = 100,003 (K6 launches exact) and
     dryrun_multichip(8) on eight logical shards; then the SIFT100M
     deployment's per-chip shard at full size (12.5M entries of 640 B,
     P = 2, C = 8,192, S = 764, Hp = 57,344, 12.8 GB packed, 3.2e9 int32
     elements): its rows hashed on the card from (id, column), a 2-shard
     ShardedPianoEngine and the single engine on route "fused" (state
     equal shard by shard after prep, after 20 batches of 16 ids, every
     served entry equal to its formula, success at least 0.98, and after
     the fused search of 4 queries, 32 steps, parallel 4, quota 64: the
     same answers and fetch counters, success within 0.03 of the model),
     launches exact (the sharded engine's twice the single's), K3 and K4
     against their plain versions at the shard's quotas, K1 at its prep
     lattice (2, 179,584, 764) and K2 at its prep gather, prep s, batch
     ms, fused ms/query with the maintenance split, resident bytes per
     engine and peak device memory; then the plaintext paths: exact
     search (ids through K6 equal to the cuBLAS form's and to a float64
     scan's; ms/query; cli.exact_search.main once), the plaintext engine
     at full width on a random graph (ms/query, recall@10 against
     brute_force_knn), and recall on the exact 32-NN graph of 131,072
     manifold vectors built by brute_force_knn, at least 0.2 above a
     random graph's; then the bench phase (bench_phase): bench_torch.py's
     three modes at full size, each a path of its own, its JSON line
     printed: "bench" (1M x 640 B: prep, batch-96 success at least 0.98,
     fused groups 1, 16, 32 and 64 with fetch success within 0.03 of the
     bound, the device-only group 1 answering valid ids), "bench big"
     (3,201,821 x 896 B, batch 32: success within 0.03 under the FCFS
     model of a batch and its retry round), both with three distinct prep
     checksums and one exact row a partition after the last prep, and
     "bench linear" (100 x 1M x 128 u32 dot products through plain torch,
     no kernel; 32 sampled products equal to numpy's mod 2^32); the host
     syncs of one device-only group-1 search by site
     (set_sync_debug_mode); K1 at the BIG prep lattice (16, 24,416, 196)
     and K2's row form at its gather (C = 1,024) against their plain
     versions, bit-equal and timed beside their bounds; then the scale
     phase (scale_phase), each script a
     path of its own, through its main() as `python -m` runs it:
     scripts.e2e_scale's canonical 1M demo (continuum data of 12 latent
     dimensions made on the card, rounds 9, keep 16, corridor 16:2:3, k
     10, step 20, parallel 3, 100 queries: build s, plaintext and private
     recall@10, private within 0.03 of plaintext, prep s, private
     ms/query, peak GiB; K1, K2 and K6, and no native_lib call),
     scripts.baselines_scale at 1M on the host-synth continuum data
     (exact recall 1.0, the cluster's recall, k-means s, ms/query; K6
     only), scripts.plan_100m (the SIFT100M per-card budget fits the
     card's memory, the mini 8-shard run over the card repeated 8 times
     at least 30/32 exact; K1 and K2), then native_lib against the plain
     torch versions on the card's host, bit-equal, at the 1M prep's
     tables (16, 12,512, 124) and K7c's ragged scan (9,001, 301, 1,000),
     host times beside the host CPU's model;
  5. every PIR path launched K1 and K2, route "pallas" K4 and the table
     engine's "fused" K3, every table-free path K5, and no path another
     route's kernel nor K6; every plaintext path K6 and no PIR kernel; no
     DevicePianoEngine, fused-search or plaintext path an attic kernel;
     the host-state engines and the private driver's paths exactly the
     kernels above; then
     _pir_select's time per call on each route.

Prints a JSON line of per-kernel results, then as its last line
{"ok": true, "device": {...}}. Any failed phase raises (non-zero exit,
no result line). Without CUDA, or outside the repository, it exits
non-zero before printing any result. Run from the repository root:

    python3 chip_smoke.py [--seed N]

Details too long for the end of the output go to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

DIM, M = 128, 32                      # 128 f32 || 32 u32 neighbor ids
ENTRY_BYTES = 4 * (DIM + M)
N, BATCH, FAIL = 1_000_000, 32, 8
ROUTES = ("xla", "pallas", "fused")
TABLE_FREE_ROUTES = ("xla", "pallas")
# the attic's kernels (pacmann_tpu_torch/ops/attic.py), by entry point:
# K7a, K7b, K7c, K7d
ATTIC = ("xor_hintgen_mm_s8p", "xor_hintgen_pallas", "xor_scan_pallas",
         "refresh_parity")
KERNELS = ("aes_mmo_tables", "xor_gather", "claim_select", "select_full",
           "aes_mmo_points", "l2_distance", *ATTIC)
# the repair pins: 3,968 B entries (960 f32 || 32 u32, k = 8 rows; K2 took
# at most 4), and 640 B entries at n = 5M (Hp = 14,336, S = 156) and 7M
# (S = 216)
WIDE_ENTRY_BYTES = 3968
BIG_N, PROTOCOL_PIN_N = 5_000_000, 7_000_000
# the benchmark's sift100m_shard4: one card's 4 of SIFT100M's 16 partitions
SHARD4_N, SHARD4_BATCH = 25_000_000, 8
# K7c's flat single-server layout: n = 1M entries of 640 B in one
# partition (C = 2,048, S = 492, B = T = 57,632)
FLAT_S, FLAT_C, FLAT_B = 492, 2048, 57_632
# K1's ragged lattice: S > 256, T * S = 300,300 (no multiple of a block of
# 256), a chunk mask that is no power of two
K1_RAGGED_T, K1_RAGGED_S, K1_RAGGED_MASK = 1001, 300, 1000
# K5's ragged list: P = 3 partitions of L = 1,001 points (no multiple of a
# block)
K5_RAGGED_P, K5_RAGGED_L = 3, 1001
# K3 at a synthetic (P, S, Hp, C) = (2, 8,192, 1,024, 16) and Q = 300: the
# found counts of S = 8,192 chunks take its shared-memory plan past 48 KiB
K3_WIDE_P, K3_WIDE_S, K3_WIDE_HP, K3_WIDE_C, K3_WIDE_Q = 2, 8192, 1024, 16, 300
# the plaintext search's full width: SIFT1M's shape and value range, with
# 1,000 queries (exact search, the engine, ground truth)
L2_Q, L2_N, KNN_N = 1000, 1_000_000, 131_072
KNN_BLOCK = 65536                     # brute_force_knn's default point block

# Peak rates of one H100 SXM for the bounds (NVIDIA's data sheet: 132 SMs,
# 1.98 GHz boost clock, HBM3 at 3.35 TB/s): int32 logic at 64 operations
# per SM per clock, shared-memory reads at 32 four-byte words per SM per
# clock (32 banks, no conflicts), fp32 FMA at 128 lanes per SM per clock
# (2 flops each: 66.9 TFLOP/s).
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
SMEM_LOOKUPS_PER_S = 132 * 32 * 1.98e9
FP32_FLOPS_PER_S = 132 * 128 * 2 * 1.98e9
# one AES-128-MMO evaluation in T-table form, low word only: 9 rounds of 16
# T-table reads, less round 1's eight reads of words 2 and 3 of the block
# (s, t << 3, 0, 0), the same for every evaluation under one key, and 4
# S-box reads; 151 XOR / OR (16 a round, 2 for the first round key, 5 for
# the last round and the feed-forward)
AES_LOOKUPS, AES_LOGIC_OPS = 9 * 16 - 8 + 4, 9 * 16 + 2 + 5


class SmokeFailure(RuntimeError):
    pass


def check(cond, what: str):
    if not cond:
        raise SmokeFailure(what)


def cuda_ms(fn, reps: int, warm: int = 1) -> float:
    """Mean ms per call over `reps` calls, timed with CUDA events."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int) -> float:
    """Mean ms per call of `reps` calls captured in one CUDA graph and
    replayed, timed with CUDA events: the device's time without the host's
    per-call gaps that cuda_ms includes when calls are short."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(a, b) -> int:
    return int((a.long() - b.long()).abs().max()) if a.numel() else 0


def bound(nbytes: float, int_ops: float = 0.0, lookups: float = 0.0,
          flops: float = 0.0) -> dict:
    """The least time the card could take: the larger of the bytes moved
    (each input read once, each output written once) over the HBM rate and
    the operations over their peak rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(int_ops / INT32_OPS_PER_S, lookups / SMEM_LOOKUPS_PER_S,
                flops / FP32_FLOPS_PER_S)
    return dict(bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bound_bytes=nbytes, bound_int_ops=int_ops,
                bound_lookups=lookups, bound_flops=flops)


def aes_bound(evals: int, nbytes: float) -> dict:
    return bound(nbytes, evals * AES_LOGIC_OPS, evals * AES_LOOKUPS)


def k1_check(rk, T: int, S: int, chunk_mask: int, label: str, reps: int,
             plain_reps: int) -> tuple[dict, object]:
    """K1 against its plain version at (P, T, S), bit-equal; timed
    back-to-back and replayed from a CUDA graph, beside its bound. Returns
    (results, the kernel's table)."""
    import torch

    from pacmann_tpu_torch.ops import aes

    got = aes.aes_mmo_cuda(rk, T, S, chunk_mask)
    want = aes.prf_tables_plain(rk, T, S, chunk_mask)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    check(err == 0, f"K1 differs from its plain version at {label} "
          f"(max err {err})")
    del want
    ms = cuda_ms(lambda: aes.aes_mmo_cuda(rk, T, S, chunk_mask), reps=reps)
    dev_ms = graph_ms(lambda: aes.aes_mmo_cuda(rk, T, S, chunk_mask),
                      reps=reps)
    plain_ms = cuda_ms(lambda: aes.prf_tables_plain(rk, T, S, chunk_mask),
                       reps=plain_reps, warm=0)
    P = rk.shape[0]
    evals = P * T * S
    b = aes_bound(evals, 4 * evals + rk.numel())
    print(f"K1 aes_mmo_tables {label} ({P},{T},{S}) mask {chunk_mask:#x}: "
          f"bit-equal to plain; kernel {ms:.4f} ms ({evals / ms / 1e6:.1f} G "
          f"evals/s; {dev_ms:.4f} ms a call replayed from a CUDA graph), "
          f"plain {plain_ms:.3f} ms, bound {b['bound_ms']:.4f} ms "
          f"({b['bound_by']})")
    return dict(max_abs_err=err, ms=ms, graph_ms=dev_ms, plain_ms=plain_ms,
                shape=[P, T, S], chunk_mask=chunk_mask, **b), got


def compare_k1(seed: int, T: int, S: int, chunk_mask: int) -> dict:
    """K1 against its plain version and the numpy oracle at (16, T, S)."""
    from pacmann_tpu_torch.ops import aes, aes_host

    rng = np.random.default_rng(seed)
    keys = [rng.bytes(16) for _ in range(16)]
    rk = aes.round_keys(keys).cuda()
    res, got = k1_check(rk, T, S, chunk_mask, "main", reps=10, plain_reps=2)
    # spot check: 4096 lattice points against the host AES oracle
    got_np = got.cpu().numpy().view(np.uint32)
    for p in range(16):
        t = rng.integers(0, T, 256).astype(np.uint64)
        s = rng.integers(0, S, 256).astype(np.uint64)
        host = (aes_host.prf_eval_u64(aes_host.expand_key(keys[p]), t, s)
                & np.uint64(chunk_mask)).astype(np.uint32)
        check(np.array_equal(got_np[p, t.astype(np.int64), s.astype(np.int64)],
                             host), f"K1 differs from aes_host (p={p})")
    print("K1 aes_mmo_tables main: bit-equal to aes_host on 4096 points")
    return dict(res, table=got, rk=rk)


def k5_points(gen, P: int, Q: int, S: int, Hp: int, T: int):
    """The main path's K5 inputs for Q rounds: tags laid out [p, {hit tag,
    backup tag}, q, s] with hit tags in [0, Hp), backup tags in [Hp, T),
    and xs = s; (P, 2*Q*S) int32 each."""
    import torch

    hit = torch.randint(0, Hp, (P, Q), generator=gen, dtype=torch.int32,
                        device="cuda")
    back = torch.randint(Hp, T, (P, Q), generator=gen, dtype=torch.int32,
                         device="cuda")
    tags = torch.stack([hit, back], dim=1)[..., None].expand(P, 2, Q, S)
    xs = torch.arange(S, dtype=torch.int32, device="cuda").expand(P, 2, Q, S)
    return (tags.reshape(P, 2 * Q * S).contiguous(),
            xs.reshape(P, 2 * Q * S).contiguous())


def k5_floor_ms(P: int, L: int) -> float:
    """ms a call of an empty kernel launched as K5 is for (P, L) (its grid,
    threads and shared memory), replayed from a CUDA graph: the floor of
    K5's replayed time at that shape."""
    import ctypes

    import torch

    from pacmann_tpu_torch.utils import cuda_lib

    fn = cuda_lib.function("aes_mmo", "aes_mmo_points_floor",
                           [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    dev = torch.device("cuda", torch.cuda.current_device())

    def empty():
        cuda_lib.check(fn(P, L, cuda_lib.stream_ptr(dev)),
                       "aes_mmo_points_floor")
    return graph_ms(empty, 50)


def k5_ragged(gen, rk, table, S: int, chunk_mask: int) -> int:
    """K5 on a ragged (K5_RAGGED_P, K5_RAGGED_L) list: half its tags u32
    values at or above 2^29 (their bits above 28 leave the input), the
    rest in [0, T), xs in [0, S); bit-equal to its plain version and, where
    the tags lie in [0, T), to K1's table. Returns the max abs error."""
    import torch

    from pacmann_tpu_torch.ops import aes

    P, L, T = K5_RAGGED_P, K5_RAGGED_L, table.shape[1]
    rk = rk[:P].contiguous()
    low = torch.randint(0, T, (P, L), generator=gen, device="cuda")
    high = torch.randint(1 << 29, 1 << 32, (P, L), generator=gen,
                         device="cuda")
    pick = torch.rand((P, L), generator=gen, device="cuda") < 0.5
    tags = torch.where(pick, high, low)
    tags = torch.where(tags >= 1 << 31, tags - (1 << 32), tags).to(
        torch.int32)
    xs = torch.randint(0, S, (P, L), generator=gen, dtype=torch.int32,
                       device="cuda")
    got = aes.aes_mmo_points_cuda(rk, tags, xs, chunk_mask)
    want = aes.prf_eval_plain(rk, tags, xs, chunk_mask)
    in_table = (tags >= 0) & (tags < T)
    from_table = table[torch.arange(P, device="cuda")[:, None],
                       tags.long().clamp(0, T - 1), xs.long()]
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    check(err == 0, f"K5 differs from its plain version on the ragged list "
          f"(max err {err})")
    check(bool(in_table.any()) and bool((~in_table).any())
          and torch.equal(got[in_table], from_table[in_table]),
          "K5 differs from K1's table on the ragged list")
    print(f"K5 aes_mmo_points ragged ({P},{L}), {int((~in_table).sum())} "
          "tags at or above 2^29: bit-equal to plain and, on the other "
          f"{int(in_table.sum())}, to K1's table")
    return err


def compare_k5(rk, table, p, quotas, seed: int) -> dict:
    """K5 against its plain version at the main path's shapes (P = 16,
    L = 2*Q*S), every output bit-equal, and against K1's table at the same
    (t, s) points; the launch floor at the first quota; a ragged list."""
    import torch

    from pacmann_tpu_torch.ops import aes

    P, T, S = table.shape
    C, Hp = p.chunk_size, p.primary_hint_num
    check(p.chunk_mask == C - 1, "chunk_mask is not C - 1")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    res = {}
    for Q in quotas:
        tags, xs = k5_points(gen, P, Q, S, Hp, T)
        got = aes.aes_mmo_points_cuda(rk, tags, xs, C - 1)
        want = aes.prf_eval_plain(rk, tags, xs, C - 1)
        from_table = table[torch.arange(P, device="cuda")[:, None],
                           tags.long(), xs.long()]
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        check(err == 0, f"K5 differs from its plain version at Q={Q} "
              f"(max err {err})")
        check(torch.equal(got, from_table),
              f"K5 differs from K1's table at Q={Q}")
        ms = cuda_ms(lambda: aes.aes_mmo_points_cuda(rk, tags, xs, C - 1),
                     reps=50)
        dev_ms = graph_ms(
            lambda: aes.aes_mmo_points_cuda(rk, tags, xs, C - 1), reps=50)
        plain_ms = cuda_ms(lambda: aes.prf_eval_plain(rk, tags, xs, C - 1),
                           reps=3)
        evals = tags.numel()
        b = aes_bound(evals, 12 * evals + rk.numel())
        floor = k5_floor_ms(P, tags.shape[1]) if Q == quotas[0] else None
        print(f"K5 aes_mmo_points Q={Q} ({P},{tags.shape[1]}): bit-equal to "
              f"plain and to K1's table; kernel {ms:.4f} ms "
              f"({evals / ms / 1e6:.2f} G evals/s; {dev_ms:.4f} ms a call "
              f"replayed from a CUDA graph"
              + ("" if floor is None else
                 f", an empty kernel of its launch shape {floor:.4f}")
              + f"), plain {plain_ms:.3f} ms, "
              f"bound {b['bound_ms']:.4f} ms ({b['bound_by']})")
        res[f"Q={Q}"] = dict(max_abs_err=err, ms=ms, graph_ms=dev_ms,
                             floor_graph_ms=floor, plain_ms=plain_ms, **b)
    res["ragged"] = dict(max_abs_err=k5_ragged(gen, rk, table, S, C - 1))
    return res


def gather_bound(off, skip, C: int, k: int) -> tuple[dict, int]:
    """The bound of a gather-XOR over (P, B, S) offsets (skip: a mask
    beside them, or None): the distinct DB entries the live offsets name,
    read once (k rows of 512 B), the offsets and the mask read once, the
    (P, B, k*128) parities written once, and one XOR per gathered word.
    Also returns the count of distinct entries."""
    import torch

    P, B, S = off.shape
    live = (off >= 0) & (off < C)
    if skip is not None:
        live &= ~skip
    p_ix = torch.arange(P, device=off.device)[:, None, None]
    s_ix = torch.arange(S, device=off.device)
    rows = torch.unique(((s_ix * P + p_ix) * C + off)[live]).numel()
    mask_bytes = 0 if skip is None else skip.numel()
    return bound(rows * k * 512 + off.numel() * 4 + mask_bytes
                 + P * B * k * 512, int_ops=int(live.sum()) * k * 128), rows


def k2_forms(db, o, k: int, label: str, reps: int, plain_reps: int,
             graph: bool = False) -> dict:
    """K2's forms (chunk-major, row-split and sliced) against the plain
    version at one input, bit-equal; each timed with CUDA events beside
    the bound. `ms` is the time of the form gather_form picks, the one the
    paths launch; `graph` adds its time replayed from a CUDA graph (the
    device's time without the host's per-call gap)."""
    import torch

    from pacmann_tpu_torch.ops import xor_scan

    S, P, CK, _ = db.shape
    C, B = CK // k, o.shape[1]
    form = xor_scan.gather_form(P, B, S, C, k)
    warps = xor_scan.row_split_warps(P, B, S, k)
    # the chunk-major ring holds C <= CHUNK_MAJOR_MAX_C rows (above, the
    # row and sliced forms alone)
    forms = (("chunk",) if C <= xor_scan.CHUNK_MAJOR_MAX_C else ()) + (
        "row", "sliced")
    b, rows = gather_bound(o, None, C, k)
    want = xor_scan.xor_gather_plain(db, o, k)
    err = 0
    for f in forms:
        got = xor_scan.xor_gather_cuda(db, o, k, form=f)
        torch.cuda.synchronize()
        e = max_abs_err(got, want)
        check(e == 0, f"K2's {f} form differs from its plain version at "
              f"{label} (max err {e})")
        err = max(err, e)
        del got
    del want
    times = {f: cuda_ms(lambda f=f: xor_scan.xor_gather_cuda(db, o, k,
                                                             form=f), reps)
             for f in forms}
    plain_ms = cuda_ms(lambda: xor_scan.xor_gather_plain(db, o, k),
                       plain_reps)
    res = dict(max_abs_err=err, form=form, row_warps=warps, ms=times[form],
               chunk_ms=times.get("chunk"), row_ms=times["row"],
               sliced_ms=times["sliced"], plain_ms=plain_ms, **b)
    note = ""
    if graph:
        res["graph_ms"] = graph_ms(
            lambda: xor_scan.xor_gather_cuda(db, o, k), reps=50)
        note = f" ({res['graph_ms']:.4f} ms replayed from a CUDA graph)"
    gb = o.numel() * k * 512 / 1e9            # entries gathered (upper bound)
    chunk = f"{times['chunk']:.4f}" if "chunk" in times else "(C too large)"
    print(f"K2 xor_gather k={k} {label} offsets {tuple(o.shape)} C={C}: "
          f"{', '.join(forms)} forms bit-equal to plain; {form} form "
          f"{times[form]:.4f} ms{note} ({gb / times[form] * 1e3:.1f} GB/s of "
          f"gathered entries), chunk {chunk} / row (W={warps}) "
          f"{times['row']:.4f} / sliced {times['sliced']:.4f} ms, plain "
          f"{plain_ms:.3f} ms, bound {b['bound_ms']:.4f} ms "
          f"({b['bound_by']}, {rows} distinct entries)")
    return res


def compare_k2(db, table, skip, quotas, seed: int, k: int = 2) -> dict:
    """K2 against its plain version at the prep shape and at the online
    server-scan shapes (Q sub-queries per partition), both forms; at k = 2
    also at both sides of the form switch (B = 16C - 1, 16C)."""
    import torch

    from pacmann_tpu_torch.ops import xor_scan

    S, P, CK, _ = db.shape
    C = CK // k
    shapes = {"prep": torch.where(skip, xor_scan.SKIP, table).contiguous()}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    for Q in quotas:
        shapes[f"Q={Q}"] = torch.randint(0, C, (P, Q, S), generator=gen,
                                         dtype=torch.int32, device="cuda")
    if k == 2:
        switch = xor_scan.CHUNK_MAJOR_MIN_REUSE * C
        for B in (switch - 1, switch):
            shapes[f"B={B}"] = torch.randint(0, C, (P, B, S), generator=gen,
                                             dtype=torch.int32, device="cuda")
    res = {}
    for name, o in shapes.items():
        prep = name == "prep"
        res[name] = k2_forms(db, o, k, name, reps=5 if prep else 50,
                             plain_reps=2 if prep else 10,
                             graph=name.startswith("Q="))
    return res


def compare_k2_ragged(seed: int) -> dict:
    """K2's forms where they split unevenly: S = 13 (not a multiple of the
    8-chunk run), B = 5,000 hints (not a multiple of a 2,048-hint block),
    k = 3, a quarter of the offsets skips and four rows that skip every
    chunk."""
    import torch

    S, P, C, k, B = 13, 16, 512, 3, 5000
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    db = torch.empty((S, P, C * k, 128), dtype=torch.int32,
                     device="cuda").random_(-2**31, 2**31, generator=gen)
    off = torch.randint(0, C, (P, B, S), generator=gen, dtype=torch.int32,
                        device="cuda")
    off[torch.rand((P, B, S), generator=gen, device="cuda") < 0.25] = -1
    off[:, :4] = -1
    return k2_forms(db, off, k, "ragged", reps=20, plain_reps=2)


def compare_k2_prep(rk, seed: int, n: int, entry_bytes: int, label: str,
                    batch: int = BATCH,
                    check_k1: bool = True) -> tuple[dict, dict | None]:
    """K1 and K2 at the prep shape of an engine of n entries of
    entry_bytes, batch 32 unless `batch` says otherwise: the 5M pin's (640
    B: P = 16, T = 35,552, S = 156, C = 2,048, 5.23 GB), bench's BIG
    deployment's (3,201,821 x 896 B: T = 24,416, S = 196, C = 1,024, 3.29
    GB) and the SIFT100M shard's (25M x 640 B, batch 8: P = 4, T =
    179,584, S = 764, C = 8,192, 25.6 GB). K1's table of those parameters
    (held against its plain version where check_k1), then K2 on it with
    the engine's skip mask, on a random DB of that shape. Returns (K2's,
    K1's results or None)."""
    import torch

    from pacmann_tpu_torch.ops import aes, xor_scan
    from pacmann_tpu_torch.pir import layout
    from pacmann_tpu_torch.pir.device_engine import _build_skip
    from pacmann_tpu_torch.pir.params import (derive_batch_params,
                                              derive_piano_params)

    c = derive_batch_params(n, entry_bytes, batch, FAIL)
    p = derive_piano_params(c.partition_size, entry_bytes, FAIL)
    S, Hp, R, C = (p.set_size, p.primary_hint_num, p.max_query_per_chunk,
                   p.chunk_size)
    T, P = Hp + S * R, c.partition_num
    k = layout.entry_rows(entry_bytes // 4)
    if check_k1:
        k1, table = k1_check(rk[:P], T, S, p.chunk_mask, label, reps=5,
                             plain_reps=1)
    else:
        k1, table = None, aes.aes_mmo_cuda(rk[:P], T, S, p.chunk_mask)
    off = torch.where(_build_skip(P, T, Hp, R, S, "cuda"), xor_scan.SKIP,
                      table).contiguous()
    del table
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    db = torch.empty((S, P, C * k, 128), dtype=torch.int32,
                     device="cuda").random_(-2**31, 2**31, generator=gen)
    res = k2_forms(db, off, k, label, reps=3, plain_reps=1)
    del db, off
    torch.cuda.empty_cache()
    return res, k1


def compare_k2_sliced(rk, seed: int) -> dict:
    """K2's sliced form where no other phase takes it: the SIFT100M
    shard's prep (its K1 table, the skip mask), and edge inputs at k = 1,
    3 and 5 and C above the chunk form's: S of 13 and 37 (no multiple of
    the 8-chunk run), B of 777, 1,000 and 5,000 (no multiple of the 256
    hints of a CTA), a quarter of the offsets -1, a twentieth C or 2^30,
    and four rows that skip every chunk. Each form against the plain
    version (k2_forms)."""
    import torch

    res = {}
    res["shard"], _ = compare_k2_prep(rk, seed, SHARD4_N, ENTRY_BYTES,
                                      "SIFT100M shard4 prep",
                                      batch=SHARD4_BATCH, check_k1=False)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    for S, P, C, k, B in ((13, 16, 600, 1, 1000), (37, 4, 1024, 3, 5000),
                          (13, 3, 520, 5, 777)):
        db = torch.empty((S, P, C * k, 128), dtype=torch.int32,
                         device="cuda").random_(-2**31, 2**31, generator=gen)
        off = torch.randint(0, C, (P, B, S), generator=gen,
                            dtype=torch.int32, device="cuda")
        for frac, value in ((0.25, -1), (0.05, C), (0.05, 1 << 30)):
            off[torch.rand((P, B, S), generator=gen, device="cuda")
                < frac] = value
        off[:, :4] = -1
        res[f"k={k}"] = k2_forms(db, off, k, f"edge k={k} S={S} B={B}",
                                 reps=10, plain_reps=1)
        del db, off
    torch.cuda.empty_cache()
    return res


def compare_k2_wide(table, skip, C: int, seed: int) -> dict:
    """K2 on entries over 2 KiB (the repair of its k <= 4 limit): k = 5
    and k = 8 on random DBs of the main deployment's geometry (S, P, C),
    at the hint-generation shape (the table and skip mask) and the Q = 96
    server-scan shape, each against its plain version."""
    import torch

    S, P = table.shape[2], table.shape[0]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    res = {}
    for k in (5, 8):
        db = torch.empty((S, P, C * k, 128), dtype=torch.int32,
                         device="cuda").random_(-2**31, 2**31, generator=gen)
        res[f"k={k}"] = compare_k2(db, table, skip, (96,), seed + k, k=k)
        del db
        torch.cuda.empty_cache()
    return res


def refresh_cases(gen, P: int, Hp: int, Ep: int) -> dict:
    """K7d's inputs at the main deployment's parity shape: (P, Hp, Ep)
    random parities; Q = 6 and Q = 96 rounds with hit slots unique per
    partition and ok at about 70 %; and Q = 96 with the second half of
    partition 0's rounds repeating its first slot (the last ok one wins)."""
    import torch

    def rand_i32(*shape):
        return torch.empty(shape, dtype=torch.int32, device="cuda").random_(
            -2**31, 2**31, generator=gen)

    ppar = rand_i32(P, Hp, Ep)
    cases = {}
    for name, Q in (("Q=6", 6), ("Q=96", 96), ("Q=96 repeated", 96)):
        hit = torch.rand((P, Hp), generator=gen, device="cuda").argsort(
            dim=1)[:, :Q].T.to(torch.int32).contiguous()
        if name.endswith("repeated"):
            hit[Q // 2:, 0] = hit[0, 0]
        ok = torch.rand((Q, P), generator=gen, device="cuda") < 0.7
        cases[name] = (ppar, rand_i32(Q, P, Ep), hit, ok)
    return cases


def refresh_bound(ppar, new_par, hit, ok) -> dict:
    """K7d's bound on one case: the rows of ppar not replaced and the
    replacing rows of new_par read once, hit and ok read once, the whole
    (P, Hp, Ep) output written once."""
    import torch

    P, Hp, Ep = ppar.shape
    p_ix = torch.arange(P, device=hit.device)[None, :].expand_as(hit)
    replaced = torch.unique((p_ix * Hp + hit)[ok]).numel()
    return bound((P * Hp - replaced) * Ep * 4 + replaced * Ep * 4
                 + hit.numel() * 5 + P * Hp * Ep * 4)


# the staged forms' launch shapes (csrc/xor_gather.cu: 512 threads, 20
# hints a thread; K7a 8 lanes a hint over 4k slices of 128 B, K7c 2 lanes
# over 16k slices of 32 B) for their shared-memory floors
STAGED_THREADS, STAGED_SLOTS = 512, 20
SMEM_WAVEFRONTS_PER_S = SMEM_LOOKUPS_PER_S / 32   # 128 bytes a wavefront


def k7a_floor(P: int, B: int, S: int, C: int, k: int) -> dict:
    """K7a's staged form in shared-memory wavefronts, one an SM a clock:
    a (hint, chunk, slice) gather reads its 128-byte row in one conflict-
    free wavefront (a skip reads the zero row), and every CTA stores each
    chunk's C rows of 128 B (C wavefronts)."""
    hints = STAGED_SLOTS * STAGED_THREADS // 8
    ctas = 4 * k * -(-B // hints) * P
    gathers, fills = P * B * S * 4 * k, ctas * S * C
    return dict(floor_ms=(gathers + fills) / SMEM_WAVEFRONTS_PER_S * 1e3,
                floor_gather_wavefronts=gathers,
                floor_fill_wavefronts=fills)


def k7c_floor(off, skip, C: int, k: int) -> dict:
    """K7c's staged form in shared-memory wavefronts: each chunk, a
    quarter-warp reads 4 consecutive hints' 32-byte rows (a skip or an
    offset outside [0, C) reads the zero row C), one wavefront for each row
    of the most crowded 128-byte bank window (row r in window r % 4; equal
    rows are one broadcast), counted on this input, per slice; every CTA
    stores each chunk's C rows of 32 B and its hints' 16-bit indices."""
    import torch

    B, S = off.shape
    rows = torch.where(skip | (off < 0) | (off >= C), C, off)
    pad = -B % 4
    rows = torch.cat([rows, rows[-1:].expand(pad, S)]) if pad else rows
    quad = rows.reshape(-1, 4, S).sort(dim=1).values
    first = torch.ones_like(quad, dtype=torch.bool)
    first[:, 1:] = quad[:, 1:] != quad[:, :-1]      # one read a distinct row
    per_phase = torch.stack([((quad % 4 == w) & first).sum(dim=1)
                             for w in range(4)]).amax(dim=0)   # (B/4, S)
    gathers = int(per_phase.sum()) * 16 * k
    hints = STAGED_SLOTS * STAGED_THREADS // 2
    blocks = -(-B // hints)
    hb = -(-B // blocks)
    hb = -(-hb // 8) * 8                            # rounded up to 8
    fills = blocks * 16 * k * S * (C * 32 + hb * 2) / 128
    return dict(floor_ms=(gathers + fills) / SMEM_WAVEFRONTS_PER_S * 1e3,
                floor_gather_wavefronts=gathers,
                floor_fill_wavefronts=fills)


def k7_forms(label: str, fn, plain, picked: str, reps: int,
             plain_reps: int, b: dict, floor: dict | None = None,
             graph: bool = False) -> dict:
    """Both forms of K7a, K7b or K7c (fn(form=...)) against the plain
    version on one input, bit-equal, each timed with CUDA events beside the
    bound (and the staged form's shared-memory floor). `ms` is the time of
    the form the entry point picks (`picked`); `graph` adds each form's
    time replayed from a CUDA graph (the device's time alone)."""
    import torch

    want = plain()
    err = 0
    for f in ("staged", "row"):
        got = fn(form=f)
        torch.cuda.synchronize()
        e = max_abs_err(got, want)
        check(e == 0, f"{label}'s {f} form differs from its plain version "
              f"(max err {e})")
        err = max(err, e)
        del got
    del want
    times = {f: cuda_ms(lambda f=f: fn(form=f), reps) for f in ("staged",
                                                                "row")}
    replay = {f: graph_ms(lambda f=f: fn(form=f), reps) for f in (
        "staged", "row")} if graph else {}
    plain_ms = cuda_ms(plain, plain_reps) if plain_reps else None
    floor = floor or {}
    print(f"{label}: both forms bit-equal to plain; picks {picked}: "
          f"staged {times['staged']:.4f} ms / row {times['row']:.4f} ms, "
          + (f"replayed from a CUDA graph staged {replay['staged']:.4f} / "
             f"row {replay['row']:.4f} ms, " if replay else "")
          + (f"plain {plain_ms:.3f} ms, " if plain_ms else "")
          + f"bound {b['bound_ms']:.4f} ms ({b['bound_by']})"
          + (f", shared-memory floor {floor['floor_ms']:.4f} ms"
             if floor else ""))
    res = dict(max_abs_err=err, form=picked, ms=times[picked],
               staged_ms=times["staged"], row_ms=times["row"],
               plain_ms=plain_ms, **floor, **b)
    if replay:
        res.update(graph_ms=replay[picked], staged_graph_ms=replay["staged"],
                   row_graph_ms=replay["row"])
    return res


def k7b_ragged(gen) -> tuple:
    """K7b's ragged input: S = 13 (no multiple of 4 or of the index
    pass's 32-chunk tile), P = 3, C = 300, k = 3, B = 5,000 >= 16C (no
    multiple of the 2,560-hint block nor of 32), a quarter skipped, four
    rows that skip every chunk, and offsets outside [0, C) that no skip
    covers."""
    import torch

    S, P, C, k, B = 13, 3, 300, 3, 5000
    db = torch.empty((S, P, C * k, 128), dtype=torch.int32,
                     device="cuda").random_(-2**31, 2**31, generator=gen)
    off = torch.randint(0, C, (P, B, S), generator=gen, dtype=torch.int32,
                        device="cuda")
    skip = torch.rand((P, B, S), generator=gen, device="cuda") < 0.25
    skip[:, :4] = True
    off[:, ::7, ::5] = C + 5
    off[:, 1::11, 2::3] = -3
    off[:, 9, :] = 65536 + 7
    return db, off, skip, k


def attic_phase(db4, table, skip, seed: int, reset,
                counted) -> tuple[dict, dict]:
    """The attic's four kernels at the main deployment's shapes. First one
    call of each entry point (K7a at sc = 1 and 4, K7d on each of its
    cases) with the launch counters set to 0 just before (`reset`) and read
    by `counted` just after: every K7 kernel launched, no other kernel. Then each kernel
    against its plain version on the same inputs, bit-equal, both timed
    with CUDA events, beside its bound:
      - K7b (xor_hintgen_pallas) on the engine's DB with K1's table and
        the skip mask, the input compare_k2 gives K2;
      - K7a (xor_hintgen_mm_s8p) on to_plane_major_s8 of that DB, same
        table and mask (timed: the kernel on the folded offsets), in both
        forms (plane_form picks "staged"); also on a random DB of k = 5
        and on offsets outside [0, C) that no skip covers (they read
        nothing, as a skip);
      - K7c (xor_scan_pallas) on a random flat DB of the single-server
        layout (FLAT_*), offsets uniform in [0, C), skip at 25 %, in both
        forms (flat_form picks "staged"); also at a ragged (C, S, B) =
        (1,000, 301, 9,001) and at B = 2,000 (flat_form picks "row"; the
        staged form forced), and with offsets outside [0, C) not skipped;
      - K7d (refresh_parity) on refresh_cases at P = 16, Hp = 3,584,
        Ep = 256; the caller's ppar unchanged.
    K7a's and K7c's staged forms print their shared-memory floors beside
    their bounds. Returns (results, launches)."""
    import torch

    from pacmann_tpu_torch.ops import attic

    S, P, CK, _ = db4.shape
    k = 2
    C = CK // k
    skip = skip.contiguous()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    t0 = time.perf_counter()
    dbp = attic.to_plane_major_s8(db4, k)
    torch.cuda.synchronize()
    print(f"to_plane_major_s8: {dbp.numel() / 1e9:.3f} GB of byte planes in "
          f"{time.perf_counter() - t0:.3f} s")
    flat = torch.empty((FLAT_S, FLAT_C * k, 128), dtype=torch.int32,
                       device="cuda").random_(-2**31, 2**31, generator=gen)
    f_off = torch.randint(0, FLAT_C, (FLAT_B, FLAT_S), generator=gen,
                          dtype=torch.int32, device="cuda")
    f_skip = torch.rand((FLAT_B, FLAT_S), generator=gen, device="cuda") < 0.25
    cases = refresh_cases(gen, P, 3584, k * 128)
    ppar = cases["Q=6"][0]
    ppar_before = ppar.clone()

    # the counted run, through the entry points
    reset()
    outs = {"K7b": attic.xor_hintgen_pallas(db4, table, skip, k)}
    for sc in (1, 4):
        outs[f"K7a sc={sc}"] = attic.xor_hintgen_mm_s8p(dbp, table, skip, k,
                                                        sc=sc)
    outs["K7c"] = attic.xor_scan_pallas(flat, f_off, f_skip, k)
    for name, case in cases.items():
        outs[f"K7d {name}"] = attic.refresh_parity(*case)
    launches = counted("attic", ATTIC)
    check(torch.equal(ppar, ppar_before), "refresh_parity wrote its input")

    res = {}

    def report(label, what, got, want, ms, plain_ms, b, note=""):
        err = max(max_abs_err(g, want) for g in got)
        check(err == 0, f"{label} {what} differs from its plain version "
              f"(max err {err})")
        print(f"{label} {what}: bit-equal to plain; kernel {ms:.4f} ms, plain "
              f"{plain_ms:.3f} ms, bound {b['bound_ms']:.4f} ms "
              f"({b['bound_by']}){note}")
        res[label] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, **b)

    # K7b: both forms at the prep shape, then at both sides of its rule
    # (B = 16C - 1, 16C) and on a ragged input; k = 5 with K7a's DB below
    T = table.shape[1]
    want = attic.xor_hintgen_pallas_plain(db4, table, skip, k)
    e = max_abs_err(outs["K7b"], want)
    check(e == 0, f"K7b's entry point differs from its plain version ({e})")
    picked = attic.hintgen_form(P, T, S, C, k)
    check(picked == "staged",
          f"hintgen_form picks {picked!r} at the main shape")
    b, rows = gather_bound(table, skip, C, k)
    res["K7b"] = k7_forms(
        f"K7b xor_hintgen_pallas {tuple(table.shape)} ({rows} distinct "
        "entries)",
        lambda form: attic.xor_hintgen_pallas_cuda(db4, table, skip, k,
                                                   form=form),
        lambda: attic.xor_hintgen_pallas_plain(db4, table, skip, k), picked,
        reps=5, plain_reps=2, b=b, graph=True)
    switch = attic.HINTGEN_STAGED_MIN_REUSE * C
    for B in (switch - 1, switch):
        o = torch.randint(0, C, (P, B, S), generator=gen, dtype=torch.int32,
                          device="cuda")
        m = torch.rand((P, B, S), generator=gen, device="cuda") < 0.25
        res[f"K7b B={B}"] = k7_forms(
            f"K7b B={B}", lambda form: attic.xor_hintgen_pallas_cuda(
                db4, o, m, k, form=form),
            lambda: attic.xor_hintgen_pallas_plain(db4, o, m, k),
            attic.hintgen_form(P, B, S, C, k), reps=5, plain_reps=0,
            b=gather_bound(o, m, C, k)[0])
        del o, m
    r_db, r_off, r_skip, r_k = k7b_ragged(gen)
    rS, rP, rCK, _ = r_db.shape
    res["K7b ragged"] = k7_forms(
        f"K7b ragged {tuple(r_off.shape)} C={rCK // r_k} k={r_k}",
        lambda form: attic.xor_hintgen_pallas_cuda(r_db, r_off, r_skip, r_k,
                                                   form=form),
        lambda: attic.xor_hintgen_pallas_plain(r_db, r_off, r_skip, r_k),
        attic.hintgen_form(rP, r_off.shape[1], rS, rCK // r_k, r_k), reps=10,
        plain_reps=0, b=gather_bound(r_off, r_skip, rCK // r_k, r_k)[0])
    del r_db, r_off, r_skip
    # K7a: the same function on the byte planes, both forms
    off = torch.where(skip, C, table).contiguous()
    want = want.reshape(P, -1, k * 128)
    check(torch.equal(attic.xor_hintgen_mm_s8p_plain(dbp, off), want),
          "K7a's plain version differs from K7b's")
    for sc in (1, 4):
        e = max_abs_err(outs[f"K7a sc={sc}"], want)
        check(e == 0, f"K7a's entry point (sc={sc}) differs from its plain "
              f"version (max err {e})")
    del want
    picked = attic.plane_form(P, T, S, C, k)
    check(picked == "staged", f"plane_form picks {picked!r} at the main shape")
    res["K7a"] = k7_forms(
        f"K7a xor_hintgen_mm_s8p {tuple(table.shape)} sc=1,4",
        lambda form: attic.xor_hintgen_mm_s8p_cuda(dbp, off, form=form),
        lambda: attic.xor_hintgen_mm_s8p_plain(dbp, off), picked, reps=5,
        plain_reps=1, b=gather_bound(off, None, C, k)[0],
        floor=k7a_floor(P, T, S, C, k))
    # K7a's edge: offsets outside [0, C) at unskipped positions read nothing
    edge = off.clone()
    edge[:, ::7, ::5] = C + 3
    edge[:, 1::11, 2::3] = -2
    edge[:, 5, :] = 65536 + 7
    res["K7a edge"] = k7_forms(
        "K7a edge (offsets outside [0, C), not skipped)",
        lambda form: attic.xor_hintgen_mm_s8p_cuda(dbp, edge, form=form),
        lambda: attic.xor_hintgen_mm_s8p_plain(dbp, edge), picked, reps=2,
        plain_reps=0, b=gather_bound(edge, None, C, k)[0])
    del dbp, edge
    torch.cuda.empty_cache()
    # K7a at k = 5 (entries over 2 KiB) on a random DB of the same geometry
    db5 = torch.empty((S, P, C * 5, 128), dtype=torch.int32,
                      device="cuda").random_(-2**31, 2**31, generator=gen)
    res["K7b k=5"] = k7_forms(
        f"K7b k=5 {tuple(table.shape)}",
        lambda form: attic.xor_hintgen_pallas_cuda(db5, table, skip, 5,
                                                   form=form),
        lambda: attic.xor_hintgen_pallas_plain(db5, table, skip, 5),
        attic.hintgen_form(P, T, S, C, 5), reps=3, plain_reps=1,
        b=gather_bound(table, skip, C, 5)[0], graph=True)
    dbp5 = attic.to_plane_major_s8(db5, 5)
    del db5
    res["K7a k=5"] = k7_forms(
        f"K7a k=5 {tuple(table.shape)}",
        lambda form: attic.xor_hintgen_mm_s8p_cuda(dbp5, off, form=form),
        lambda: attic.xor_hintgen_mm_s8p_plain(dbp5, off),
        attic.plane_form(P, T, S, C, 5), reps=3, plain_reps=1,
        b=gather_bound(off, None, C, 5)[0], floor=k7a_floor(P, T, S, C, 5))
    del dbp5, off
    torch.cuda.empty_cache()
    # K7c at the flat layout, both forms; the entry point's output too
    picked = attic.flat_form(FLAT_B, FLAT_S, FLAT_C, k)
    check(picked == "staged", f"flat_form picks {picked!r} at the main shape")
    e = max_abs_err(outs["K7c"], attic.xor_scan_pallas_plain(flat, f_off,
                                                             f_skip, k))
    check(e == 0, f"K7c's entry point differs from its plain version ({e})")
    b, rows = gather_bound(f_off[None], f_skip[None], FLAT_C, k)
    res["K7c"] = k7_forms(
        f"K7c xor_scan_pallas ({FLAT_B}, {FLAT_S}) C={FLAT_C} "
        f"({rows} distinct entries)",
        lambda form: attic.xor_scan_pallas_cuda(flat, f_off, f_skip, k,
                                                form=form),
        lambda: attic.xor_scan_pallas_plain(flat, f_off, f_skip, k), picked,
        reps=5, plain_reps=1, b=b, floor=k7c_floor(f_off, f_skip, FLAT_C, k))
    # ... at B = 2,000 < 20C, where flat_form picks the row form
    sb_off, sb_skip = f_off[:2000].contiguous(), f_skip[:2000].contiguous()
    res["K7c B=2000"] = k7_forms(
        "K7c B=2000", lambda form: attic.xor_scan_pallas_cuda(
            flat, sb_off, sb_skip, k, form=form),
        lambda: attic.xor_scan_pallas_plain(flat, sb_off, sb_skip, k),
        attic.flat_form(2000, FLAT_S, FLAT_C, k), reps=10, plain_reps=0,
        b=gather_bound(sb_off[None], sb_skip[None], FLAT_C, k)[0],
        floor=k7c_floor(sb_off, sb_skip, FLAT_C, k))
    # ... with offsets outside [0, C) that no skip covers
    edge = f_off.clone()
    edge[::7, ::5] = FLAT_C + 1
    edge[1::11, 2::3] = -5
    edge[3] = 65535
    res["K7c edge"] = k7_forms(
        "K7c edge (offsets outside [0, C), not skipped)",
        lambda form: attic.xor_scan_pallas_cuda(flat, edge, f_skip, k,
                                                form=form),
        lambda: attic.xor_scan_pallas_plain(flat, edge, f_skip, k), picked,
        reps=2, plain_reps=0,
        b=gather_bound(edge[None], f_skip[None], FLAT_C, k)[0])
    del flat, f_off, f_skip, sb_off, sb_skip, edge
    torch.cuda.empty_cache()
    # ... at a ragged shape: C = 1,000, S = 301, B = 9,001, all-skip rows
    rc, rs, rb = 1000, 301, 9001
    rflat = torch.empty((rs, rc * k, 128), dtype=torch.int32,
                        device="cuda").random_(-2**31, 2**31, generator=gen)
    r_off = torch.randint(0, rc, (rb, rs), generator=gen, dtype=torch.int32,
                          device="cuda")
    r_skip = torch.rand((rb, rs), generator=gen, device="cuda") < 0.25
    r_skip[:3] = True
    res["K7c ragged"] = k7_forms(
        f"K7c ragged ({rb}, {rs}) C={rc}",
        lambda form: attic.xor_scan_pallas_cuda(rflat, r_off, r_skip, k,
                                                form=form),
        lambda: attic.xor_scan_pallas_plain(rflat, r_off, r_skip, k),
        attic.flat_form(rb, rs, rc, k), reps=10, plain_reps=1,
        b=gather_bound(r_off[None], r_skip[None], rc, k)[0],
        floor=k7c_floor(r_off, r_skip, rc, k))
    del rflat, r_off, r_skip
    # K7d
    for name, case in cases.items():
        report(f"K7d {name}", "refresh_parity", [outs[f"K7d {name}"]],
               attic.refresh_parity_plain(*case),
               cuda_ms(lambda: attic.refresh_parity_cuda(*case), reps=50),
               cuda_ms(lambda: attic.refresh_parity_plain(*case), reps=5),
               refresh_bound(*case))
    del outs, cases
    torch.cuda.empty_cache()
    return res, launches


def protocol_inputs(gen, kind: str, Q: int, table, p, P: int,
                    psize: int) -> list:
    """Full-width K3 inputs on the card: the prep's slot columns and
    offset table, random program points (half unset), tags, replacement
    indices, budgets and dummy rows; idx_q (Q, P) local ids with 10 %
    dummy rounds. kind "contended": every round of a partition asks one
    id; "budget": one replacement left in every chunk (hist = R - 1), two
    admissions left (finished = max_q - 2) and rounds repeating chunks;
    "deep": every round of a partition asks one id whose slot-column row
    has a tenth of its slots eligible (col == off, unprogrammed), so more
    than K3's kept candidates contend for one row and its walk scans the
    row on."""
    import torch

    from pacmann_tpu_torch.pir.params import DEFAULT_PROGRAM_POINT as DPP

    S, Hp, C, R = (p.set_size, p.primary_hint_num, p.chunk_size,
                   p.max_query_per_chunk)
    T = table.shape[1]

    def ri(hi, *shape):
        return torch.randint(0, hi, shape, generator=gen, dtype=torch.int32,
                             device="cuda")

    slot_col = table[:, :Hp, :].transpose(1, 2).contiguous()
    prog = torch.where(torch.rand((P, Hp), generator=gen, device="cuda")
                       < 0.5, DPP, ri(S * C, P, Hp))
    repl_idx = ri(C, P, S, R) + C * torch.arange(
        S, dtype=torch.int32, device="cuda")[None, :, None]
    hist = ri(R, P, S)
    finished = ri(p.max_query_num // 2, P)
    idx_q = ri(psize, Q, P)
    if kind == "contended":
        idx_q[1:] = idx_q[0].clone()
    elif kind == "budget":
        hist.fill_(R - 1)
        finished.fill_(p.max_query_num - 2)
        idx_q[Q // 2:] = idx_q[0].clone()
    elif kind == "deep":
        idx_q[1:] = idx_q[0].clone()
        p_ix = torch.arange(P, device="cuda")
        ck, off = (idx_q[0] // C).long(), idx_q[0] % C
        deep = torch.rand((P, Hp), generator=gen, device="cuda") < 0.1
        rows = slot_col[p_ix, ck]
        slot_col[p_ix, ck] = torch.where(deep, off[:, None], rows)
        prog[deep] = DPP
    idx_q[torch.rand((Q, P), generator=gen, device="cuda") < 0.1] = -1
    return [slot_col, prog, ri(T, P, Hp), table, repl_idx, hist, finished,
            idx_q, ri(C, Q, P, S)]


def protocol_bounds(a, sel, S: int, Hp: int) -> tuple[dict, dict]:
    """K3's and K4's bounds on one round set, counting what its data
    needs: each real round's slot-column row (distinct (p, chunk)), the
    program points, and for K3 each served round's tag, table row and
    replacement index, each unserved round's dummy row, the budgets; the
    outputs once. Operations: three compares per slot of a real round."""
    import torch

    slot_col, prog, tag, table, repl_idx, hist, finished, idx_q, rnd = a
    hit, ok_q, ok_r, ig, chunk, idxu = sel
    Q, P = idx_q.shape
    T = table.shape[1]
    p_ix = torch.arange(P, device=idx_q.device)[None, :].expand(Q, P)
    real = idx_q >= 0
    rows = torch.unique((p_ix * S + chunk)[real]).numel()
    ops = int(real.sum()) * Hp * 3
    qp = Q * P
    k4 = bound(rows * Hp * 4 + prog.numel() * 4 + qp * (4 + 4 + 1)
               + qp * (4 + 1), int_ops=ops)
    served = int(ok_q.sum())
    trows = torch.unique((p_ix * T + tag[p_ix, hit])[ok_q]).numel()
    k3 = bound(rows * Hp * 4 + prog.numel() * 4 + served * (4 + 4)
               + trows * S * 4 + (qp - served) * S * 4
               + torch.unique((p_ix * S + chunk)).numel() * 4
               + finished.numel() * 4 + qp * 4
               + qp * S * 4 + qp * (4 * 4 + 2), int_ops=ops)
    return k3, k4


def k3_rescans(a, sel, C: int) -> int:
    """Rounds of one K3 call whose slot lies past the first K =
    min(Q, SELECT_CANDIDATES) eligible slots of its row: those K3's walk
    found by scanning the row on, its candidates all claimed. From the
    call's inputs `a` and its outputs `sel`."""
    import torch

    from pacmann_tpu_torch.ops import protocol_kernels as pk
    from pacmann_tpu_torch.pir.params import DEFAULT_PROGRAM_POINT as DPP

    slot_col, prog, idx_q = a[0], a[1], a[7]
    hit, _, _, _, chunk, idxu = sel
    Q, P = idx_q.shape
    S = slot_col.shape[1]
    pc = torch.where(prog != DPP, torch.div(prog, C, rounding_mode="floor"),
                     -1)
    K = min(Q, pk.SELECT_CANDIDATES)
    p_ix = torch.arange(P, device=prog.device)[None, :]
    took = 0
    for q0 in range(0, Q, 256):         # (256, P, Hp) rows at a time
        ck, h = chunk[q0:q0 + 256], hit[q0:q0 + 256].long()[..., None]
        live = (idx_q[q0:q0 + 256] >= 0) & (ck < S)
        rows = slot_col[p_ix, ck.clamp(max=S - 1).long()]
        elig = ((rows == (idxu[q0:q0 + 256] % C)[..., None])
                & (pc[None] != ck[..., None]) & live[..., None])
        before = (elig.cumsum(-1) - elig.long()).gather(-1, h)[..., 0]
        took += int((elig.gather(-1, h)[..., 0] & (before >= K)).sum())
    return took


def compare_protocol(table, p, P: int, psize: int, quotas, seed: int,
                     kinds=("uniform", "contended", "budget", "deep"),
                     plain_reps: int = 3) -> dict:
    """K3 and K4 against their plain versions, every output bit-equal,
    with the rounds that took a row scan in the walk; times of the uniform
    case (CUDA events over back-to-back calls, and replayed from a CUDA
    graph; the plain versions' only where plain_reps > 0) and, replayed, of
    the deep case."""
    import torch

    from pacmann_tpu_torch.ops import protocol_kernels as pk
    from pacmann_tpu_torch.pir.params import DEFAULT_PROGRAM_POINT as DPP

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    kw = dict(C=p.chunk_size, R=p.max_query_per_chunk,
              Hp=p.primary_hint_num, S=p.set_size, max_q=p.max_query_num,
              dpp=DPP)
    res = {}
    for Q in quotas:
        for kind in kinds:
            a = protocol_inputs(gen, kind, Q, table, p, P, psize)
            sel, qs = pk.select_full_cuda(*a, **kw)
            sel_p, qs_p = pk.select_full_plain(*a, **kw)
            real = a[7] >= 0
            claim_args = (a[0], a[1], sel_p[4], sel_p[5] % p.chunk_size, real)
            hit, fnd = pk.claim_select_cuda(*claim_args, C=p.chunk_size,
                                            dpp=DPP)
            hit_p, fnd_p = pk.claim_select_plain(*claim_args,
                                                 C=p.chunk_size, dpp=DPP)
            torch.cuda.synchronize()
            k3_err = max(max_abs_err(x, y) for x, y in
                         zip((qs, *sel), (qs_p, *sel_p)))
            k4_err = max(max_abs_err(hit, hit_p), max_abs_err(fnd, fnd_p))
            check(k3_err == 0, f"K3 differs from its plain version at Q={Q} "
                  f"{kind} (max err {k3_err})")
            check(k4_err == 0, f"K4 differs from its plain version at Q={Q} "
                  f"{kind} (max err {k4_err})")
            served, found = int(sel_p[1].sum()), int(fnd_p.sum())
            row = dict(k3_err=k3_err, k4_err=k4_err, served=served,
                       found=found, real=int(real.sum()),
                       rescans=k3_rescans(a, sel_p, p.chunk_size))
            kept = min(Q, pk.SELECT_CANDIDATES)
            if kind == "deep" and Q >= kept + 2:
                # every partition found at least K + 2 slots of its one
                # row: the walk scanned that row on
                least = int(fnd_p.sum(dim=0).min())
                check(least >= kept + 2 and row["rescans"] > 0,
                      f"K3 deep Q={Q}: a partition found {least} slots "
                      f"(K + 2 = {kept + 2}), {row['rescans']} row scans")

            def k3():
                return pk.select_full_cuda(*a, **kw)

            def k4():
                return pk.claim_select_cuda(*claim_args, C=p.chunk_size,
                                            dpp=DPP)
            if kind == "deep":
                row.update(k3_graph_ms=graph_ms(k3, 50),
                           k4_graph_ms=graph_ms(k4, 50))
                times = (f"; replayed from a CUDA graph: K3 "
                         f"{row['k3_graph_ms']:.4f} ms, K4 "
                         f"{row['k4_graph_ms']:.4f} ms")
            elif kind == "uniform":
                k3_b, k4_b = protocol_bounds(a, sel_p, p.set_size,
                                             p.primary_hint_num)
                row.update(k3_bound=k3_b, k4_bound=k4_b)
                row.update(
                    k3_ms=cuda_ms(k3, 50), k3_graph_ms=graph_ms(k3, 50),
                    k4_ms=cuda_ms(k4, 50), k4_graph_ms=graph_ms(k4, 50))
                if plain_reps:
                    row.update(
                        k3_plain_ms=cuda_ms(lambda: pk.select_full_plain(
                            *a, **kw), plain_reps),
                        k4_plain_ms=cuda_ms(lambda: pk.claim_select_plain(
                            *claim_args, C=p.chunk_size, dpp=DPP),
                            plain_reps))
                k3_plain, k4_plain = (
                    (f", plain {row['k3_plain_ms']:.3f} ms",
                     f", plain {row['k4_plain_ms']:.3f} ms") if plain_reps
                    else ("", ""))
                times = (f"; K3 kernel {row['k3_ms']:.4f} ms "
                         f"({row['k3_graph_ms']:.4f} replayed from a CUDA "
                         f"graph){k3_plain}, bound "
                         f"{k3_b['bound_ms']:.4f} ({k3_b['bound_by']}); K4 "
                         f"kernel {row['k4_ms']:.4f} ms "
                         f"({row['k4_graph_ms']:.4f} replayed){k4_plain}, "
                         f"bound {k4_b['bound_ms']:.4f} ({k4_b['bound_by']})")
            else:
                times = ""
            print(f"K3 select_full + K4 claim_select (P, S, Hp) = ({P}, "
                  f"{p.set_size}, {p.primary_hint_num}) Q={Q} {kind}: "
                  "bit-equal "
                  f"to plain ({row['real']} real rounds, {found} found, "
                  f"{served} served, {row['rescans']} by a row scan in K3)"
                  f"{times}")
            res[f"Q={Q} {kind}"] = row
    return res


def compare_k4_edge(table, p, P: int, Q: int, seed: int) -> dict:
    """K4 on rounds the engines never send, at Hp % 4 = 0 (4-slot loads)
    and Hp % 4 = 3 (one-slot loads): rounds that are not real with any
    chunk (-1, S and far outside) and any int32 offset; real rounds with a
    chunk of -1 or S, for which K4 reads nothing; real rounds asking offset
    -1 of rows that hold it at a few slots, so that a load padded with a
    value equal to -1 past the row would claim a slot >= Hp. Held against
    its plain version on the same rounds with every round that is not real
    or out of range made an unreal round on chunk 0, offset 0: by the
    contract such a round finds nothing and claims nothing, whatever its
    chunk and offset."""
    import torch

    from pacmann_tpu_torch.ops import protocol_kernels as pk
    from pacmann_tpu_torch.pir.params import DEFAULT_PROGRAM_POINT as DPP

    S, Hp, C = p.set_size, p.primary_hint_num, p.chunk_size
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)

    def ri(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=gen, dtype=torch.int32,
                             device="cuda")

    def coin(prob, *shape):
        return torch.rand(shape, generator=gen, device="cuda") < prob

    res = {}
    for hp in (Hp - Hp % 4, Hp - Hp % 4 - 1):
        slot_col = table[:, :hp, :].transpose(1, 2).contiguous()
        slot_col[coin(0.0005, P, S, hp)] = -1
        prog = torch.where(coin(0.5, P, hp), DPP, ri(0, S * C, P, hp))
        chunk_q, off_q = ri(0, S, Q, P), ri(0, C, Q, P)
        real_q = coin(0.8, Q, P)
        # offset -1, on a few chunks a partition so its -1 slots run out
        neg = coin(0.3, Q, P)
        chunk_q[neg] = ri(0, 3, Q, P)[neg]
        off_q[neg] = -1
        junk = ~real_q
        far = torch.tensor([-1, S, S + 7, -(1 << 30), 1 << 30],
                           dtype=torch.int32, device="cuda")
        chunk_q[junk] = far[ri(0, 5, Q, P)][junk]
        off_q[junk] = ri(-(1 << 31), (1 << 31) - 1, Q, P)[junk]
        out = real_q & coin(0.1, Q, P)
        chunk_q[out] = far[ri(0, 2, Q, P)][out]
        hit, fnd = pk.claim_select_cuda(slot_col, prog, chunk_q, off_q,
                                        real_q, C=C, dpp=DPP)
        live = real_q & (chunk_q >= 0) & (chunk_q < S)
        zero = torch.zeros_like(chunk_q)
        hit_p, fnd_p = pk.claim_select_plain(
            slot_col, prog, torch.where(live, chunk_q, zero),
            torch.where(live, off_q, zero), live, C=C, dpp=DPP)
        torch.cuda.synchronize()
        err = max(max_abs_err(hit, hit_p), max_abs_err(fnd, fnd_p))
        check(err == 0, f"K4 differs from its plain version on the edge "
              f"input at Hp={hp} (max err {err})")
        found_neg = int((fnd_p & neg & live).sum())
        missed_neg = int((~fnd_p & neg & live).sum())
        check(found_neg > 0 and missed_neg > 0,
              f"K4 edge input at Hp={hp}: offset -1 found {found_neg}, "
              f"missed {missed_neg}: the input does not test the padding")
        print(f"K4 claim_select edge input (P, S, Hp) = ({P}, {S}, {hp}) "
              f"Q={Q}: bit-equal to plain ({int(junk.sum())} unreal rounds, "
              f"{int((real_q & ~live).sum())} real rounds outside [0, S), "
              f"offset -1 found {found_neg} and missed {missed_neg} times)")
        res[f"Hp={hp}"] = dict(k4_err=err, found_neg=found_neg,
                               missed_neg=missed_neg)
    return res


def compare_k3_wide(seed: int) -> dict:
    """K3 and K4 against their plain versions at K3_WIDE_*, uniform and
    contended: their plan passes the 48 KiB default, so their launches opt
    in, on clusters of 8 CTAs over two windows of rounds."""
    from types import SimpleNamespace

    import torch

    from pacmann_tpu_torch.ops import protocol_kernels as pk

    P, S, Hp, C = K3_WIDE_P, K3_WIDE_S, K3_WIDE_HP, K3_WIDE_C
    need = pk.select_smem_bytes(Hp, S)
    check(need > 48 * 1024, f"K3/K4 wide: plan {need} B needs no opt-in")
    print(f"K3/K4 wide (P, S, Hp) = ({P}, {S}, {Hp}): plan {need} B a CTA")
    p = SimpleNamespace(set_size=S, primary_hint_num=Hp, chunk_size=C,
                        max_query_per_chunk=4, max_query_num=1000)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    table = torch.randint(0, C, (P, 2 * Hp, S), generator=gen,
                          dtype=torch.int32, device="cuda")
    return compare_protocol(table, p, P, S * C, (K3_WIDE_Q,), seed,
                            kinds=("uniform", "contended"), plain_reps=1)


def fused_rescans(e, fs, raw: np.ndarray, seed: int) -> dict:
    """One untimed batch-96 on a "fused" engine and, given its fused
    search, one group-16 and one group-1 search, with K3's calls counted:
    launches, real rounds, and rounds its walk found by scanning a row on
    (k3_rescans)."""
    from pacmann_tpu_torch.ops import protocol_kernels as pk

    kernel = pk.select_full_cuda
    tally = dict(launches=0, rounds=0, rescans=0)

    def counted(*a, **kw):
        sel, qs = kernel(*a, **kw)
        tally["launches"] += 1
        tally["rounds"] += int((a[7] >= 0).sum())
        tally["rescans"] += k3_rescans(a, sel, kw["C"])
        return sel, qs

    # the kernel's wrapper adds to the launch counter of the module's
    # select_full_cuda, which is `counted` meanwhile
    counted.launches = 0
    pk.select_full_cuda = counted
    try:
        rng = np.random.default_rng(seed)
        e.query([int(i) for i in rng.integers(0, raw.shape[0], 96)])
        if fs is not None:
            for G in (16, 1):
                fs.ensure_budget(20, G, 3)
                fs.search(rng.random((G, DIM), dtype=np.float32), k=10,
                          max_step=20, parallel=3)
    finally:
        pk.select_full_cuda = kernel
    print(f"K3 on the engine's own rounds: {tally['launches']} launches, "
          f"{tally['rounds']} real rounds, {tally['rescans']} by a row scan")
    return tally


def small_parity(seed: int, route: str, table_free: bool = False):
    """The CUDA path (kernels) and the CPU path (plain versions) of the
    engine and the fused search on one protocol route, with the table or
    table-free, same seeds, small size: identical state, answers and
    counters."""
    import torch

    from pacmann_tpu_torch.pir.convert import state_to_numpy
    from pacmann_tpu_torch.pir.device_engine import DevicePianoEngine
    from pacmann_tpu_torch.private.fused_search import (
        FusedPrivateSearch, draw_step_randoms)

    rng = np.random.default_rng(seed)
    n, d, m = 4096, 8, 8
    vecs = rng.integers(0, 8, size=(n, d)).astype(np.float32)
    graph = rng.integers(0, n, size=(n, m)).astype(np.uint32)
    raw = np.concatenate([vecs.view(np.uint32), graph], axis=1)
    sids = rng.choice(n, 64, replace=False)
    queries = rng.integers(0, 8, size=(2, d)).astype(np.float32)
    runs = {}
    for dev in ("cuda", "cpu"):
        e = DevicePianoEngine(n, 4 * (d + m), m, raw, 8, device=dev,
                              kernel_route=route, table_free=table_free)
        e.preprocessing(rng=np.random.default_rng(seed + 1))
        prep_state = state_to_numpy(e.state)
        outs = [e.query([int(i) for i in np.random.default_rng(s).integers(
            0, n, 8)]) for s in range(3)]
        fs = FusedPrivateSearch(e, sids, vecs[sids], graph[sids].astype(
            np.int64), dim=d, m=m, n=n)
        gen = torch.Generator()
        gen.manual_seed(seed + 2)
        randoms = draw_step_randoms(
            gen, max_step=6, Qn=2, parallel=2, m=m, n=n,
            quota=2 * 2 * m // e.config.partition_num, P=e.config.partition_num,
            S=e.params.set_size, C=e.params.chunk_size, device="cpu")
        ids, steps = fs.search(queries, k=5, max_step=6, parallel=2,
                               step_randoms=[r.numpy() for r in randoms],
                               return_steps=True)
        runs[dev] = (prep_state, outs, ids, steps, fs.fetch_stats.copy(),
                     state_to_numpy(e.state))
    a, b = runs["cuda"], runs["cpu"]
    for key in a[0]:
        check(np.array_equal(a[0][key], b[0][key]),
              f"small parity: prep state {key} differs")
    for x, y in zip(a[1], b[1]):
        check(np.array_equal(x, y), "small parity: query answers differ")
    for i in range(2, 5):
        check(np.array_equal(a[i], b[i]), "small parity: search differs")
    for key in a[5]:
        check(np.array_equal(a[5][key], b[5][key]),
              f"small parity: state {key} differs after search")
    print(f"small-input parity, route {route}"
          f"{' table-free' if table_free else ''}: CUDA path == CPU plain "
          "path (prep state, 3 query batches, fused search ids/steps/stats, "
          "final state)")


def route_identity(db, raw: np.ndarray, seed: int, batches: int = 10):
    """One engine per protocol route, and a table-free one on "xla" and
    "pallas", on the same DB and seeds: identical answers, and identical
    state (every array but the table or the round keys) after every batch
    of 96 ids."""
    import torch

    from pacmann_tpu_torch.pir.device_engine import (
        STATE_KEYS, DevicePianoEngine)

    engines = {}
    for route, tf in [(r, False) for r in ROUTES] + [
            (r, True) for r in TABLE_FREE_ROUTES]:
        e = DevicePianoEngine(N, ENTRY_BYTES, BATCH, None, FAIL,
                              packed_db=db, kernel_route=route,
                              table_free=tf)
        e.preprocessing(rng=np.random.default_rng(seed))
        engines[route + (" table-free" if tf else "")] = e
    for name, e in engines.items():
        check(("table" in e.state) != e.table_free
              and ("rk" in e.state) == e.table_free,
              f"{name}: state holds {sorted(e.state)}")
    ref = engines["xla"]
    keys = STATE_KEYS[1:]
    for key in keys:
        for name, e in engines.items():
            check(torch.equal(e.state[key], ref.state[key]),
                  f"{name}: prep state {key} differs from xla")
    rng = np.random.default_rng(seed + 1)
    for b in range(batches):
        ids = [int(i) for i in rng.integers(0, N, 96)]
        outs = {name: e.query(ids) for name, e in engines.items()}
        for name, e in engines.items():
            check(np.array_equal(outs[name], outs["xla"]),
                  f"{name}: answers differ from route xla, batch {b}")
            for key in keys:
                check(torch.equal(e.state[key], ref.state[key]),
                      f"{name}: state {key} differs from xla, batch {b}")
    print(f"route identity at full size: {', '.join(engines)} give the "
          f"same answers and state ({', '.join(keys)}) after prep and each "
          f"of {batches} batches of 96 ids")


def resident_state(db, seed: int) -> dict:
    """Bytes of client state resident after preprocessing, from
    torch.cuda.memory_allocated before and after it (one warm prep first),
    with the table and table-free; the difference must be the table less
    the round keys."""
    import torch

    from pacmann_tpu_torch.pir.device_engine import DevicePianoEngine

    out = {}
    for tf in (False, True):
        e = DevicePianoEngine(N, ENTRY_BYTES, BATCH, None, FAIL,
                              packed_db=db, table_free=tf)
        e.preprocessing(rng=np.random.default_rng(seed))
        e.state = None
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        e.preprocessing(rng=np.random.default_rng(seed))
        torch.cuda.synchronize()
        out["table-free" if tf else "table"] = dict(
            allocated=torch.cuda.memory_allocated() - before,
            tensors=sum(t.numel() * t.element_size()
                        for t in e.state.values()),
            extra_storage_size=e.extra_storage_size())
        if not tf:
            table_bytes = e.state["table"].numel() * 4
        del e
    saved = out["table"]["allocated"] - out["table-free"]["allocated"]
    print(f"resident client state after prep: table engine "
          f"{out['table']['allocated']} B, table-free "
          f"{out['table-free']['allocated']} B (memory_allocated deltas); "
          f"the table-free engine holds {saved} B less (table "
          f"{table_bytes} B); extra_storage_size (the JAX formula) "
          f"{out['table']['extra_storage_size']:.0f} / "
          f"{out['table-free']['extra_storage_size']:.0f} B")
    check(abs(saved - table_bytes) <= 1 << 20,
          f"table-free engine saves {saved} B, not the table's {table_bytes}")
    out["saved"] = saved
    return out


def measure_comm_phase(db, seed: int, batches: int = 3) -> dict:
    """A table-free "pallas" engine in measure_comm mode against the
    unmeasured table engine on "xla", same seeds: the same answers and
    state after each batch of 96 ids, and message bytes equal to the
    analytic model (each round uploads quota*P offset vectors of S u32
    and downloads quota*P entries)."""
    import torch

    from pacmann_tpu_torch.pir.device_engine import (
        STATE_KEYS, DevicePianoEngine)

    e = DevicePianoEngine(N, ENTRY_BYTES, BATCH, None, FAIL, packed_db=db,
                          kernel_route="pallas", table_free=True,
                          measure_comm=True)
    ref = DevicePianoEngine(N, ENTRY_BYTES, BATCH, None, FAIL, packed_db=db,
                            kernel_route="xla")
    for x in (e, ref):
        x.preprocessing(rng=np.random.default_rng(seed))
        x._rng = np.random.default_rng(seed + 1)
    rng = np.random.default_rng(seed + 2)
    P, S = e.config.partition_num, e.params.set_size
    quota = 96 // P
    lat = []
    for b in range(batches):
        ids = [int(i) for i in rng.integers(0, N, 96)]
        t0 = time.perf_counter()
        out = e.query(ids)
        lat.append((time.perf_counter() - t0) * 1e3)
        check(np.array_equal(out, ref.query(ids)),
              f"measure_comm: answers differ from the table engine, batch {b}")
        for key in STATE_KEYS[1:]:
            check(torch.equal(e.state[key], ref.state[key]),
                  f"measure_comm: state {key} differs, batch {b}")
    rounds = batches * (1 + e.query_retries)
    up = rounds * quota * P * S * 4
    down = rounds * quota * P * ENTRY_BYTES
    print(f"measure_comm (table-free, pallas): {batches} batches of 96 ids "
          f"equal the table engine's answers and state; uploaded "
          f"{e.uploaded_bytes} B (model {up}), downloaded "
          f"{e.downloaded_bytes} B (model {down}); batch ms "
          + ", ".join(f"{t:.3f}" for t in lat))
    check(e.uploaded_bytes == up and e.downloaded_bytes == down,
          "measure_comm byte counts differ from the analytic model")
    return dict(uploaded=e.uploaded_bytes, downloaded=e.downloaded_bytes,
                batch96_ms=lat)


def pir_select_times(engine, quotas, seed: int, reps: int = 20) -> dict:
    """_pir_select per call on each route at the main path's quotas, on
    the engine's state: host clock over `reps` calls ending in a sync
    (the "xla" route syncs the host once per fixpoint pass). Routes are
    timed in turns, xla pallas fused fused pallas xla."""
    import torch

    from pacmann_tpu_torch.pir.device_engine import _pir_select
    from pacmann_tpu_torch.pir.params import DEFAULT_PROGRAM_POINT as DPP

    p = engine.params
    P = engine.config.partition_num
    st = engine.state
    carry = (st["tag"], st["prog"], st["primary_parity"], st["slot_col"],
             st["hist"], st["finished"])
    kw = dict(C=p.chunk_size, R=p.max_query_per_chunk,
              Hp=p.primary_hint_num, S=p.set_size, max_q=p.max_query_num,
              dpp=DPP)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    out = {}
    for Q in quotas:
        idx_q = torch.randint(0, engine.config.partition_size, (Q, P),
                              generator=gen, dtype=torch.int32, device="cuda")
        rnd = torch.randint(0, p.chunk_size, (Q, P, p.set_size),
                            generator=gen, dtype=torch.int32, device="cuda")
        times = {r: [] for r in ROUTES}
        for route in ROUTES + ROUTES[::-1]:
            def call():
                return _pir_select(st["table"], st["repl_idx"], carry,
                                   idx_q, rnd, route=route, **kw)
            call()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                call()
            torch.cuda.synchronize()
            times[route].append((time.perf_counter() - t0) * 1e3 / reps)
        out[f"Q={Q}"] = times
        print(f"_pir_select ms per call at Q={Q} (host clock, {reps} calls, "
              "two turns): " + ", ".join(
                  f"{r} {t[0]:.3f}/{t[1]:.3f}" for r, t in times.items()))
    return out


# the host-state engines' full-size runs: queries of PianoPIR (one
# partition over all N entries), batches of the two batch engines
HOST_QUERIES, HOST_BATCHES = 200, 100
# the spies' rules: the form each wrapper picks where none is forced
FORM_RULES = (("attic", "flat_form"), ("attic", "hintgen_form"),
              ("xor_scan", "gather_form"))


@contextlib.contextmanager
def form_spy():
    """Counts the forms the wrappers of K7c, K7b and K2 pick while the
    block runs: each rule is wrapped, and restored on leaving. Yields a
    Counter of (rule, form)."""
    from pacmann_tpu_torch.ops import attic, xor_scan

    mods = {"attic": attic, "xor_scan": xor_scan}
    seen = collections.Counter()
    saved = {}

    def spy(name, rule):
        def picked(*a):
            form = rule(*a)
            seen[(name, form)] += 1
            return form
        return picked

    for mod, name in FORM_RULES:
        saved[(mod, name)] = getattr(mods[mod], name)
        setattr(mods[mod], name, spy(name, saved[(mod, name)]))
    try:
        yield seen
    finally:
        for (mod, name), rule in saved.items():
            setattr(mods[mod], name, rule)


def clients_of(engine) -> list:
    """The numpy client state machines of a host-state engine."""
    if hasattr(engine, "clients"):
        return engine.clients
    if hasattr(engine, "sub_pir"):
        return [s.client for s in engine.sub_pir]
    return [engine.client]


def same_clients(a, b) -> bool:
    """Every ClientState field and cache of two engines' clients equal."""
    import dataclasses

    for x, y in zip(clients_of(a), clients_of(b), strict=True):
        for f in dataclasses.fields(x.state):
            if not np.array_equal(getattr(x.state, f.name),
                                  getattr(y.state, f.name)):
                return False
        if sorted(x.cache) != sorted(y.cache) or not all(
                np.array_equal(x.cache[i], y.cache[i]) for i in x.cache):
            return False
    return True


def host_parity(seed: int) -> None:
    """The three host-state engines on CUDA against the same engine on the
    CPU (plain versions) at a small size: the same answers and client
    state after prep and after every query or batch."""
    from pacmann_tpu_torch.pir.batch import SimpleBatchPianoPIR
    from pacmann_tpu_torch.pir.engine import FusedBatchPianoPIR
    from pacmann_tpu_torch.pir.piano import PianoPIR, QueryError

    rng = np.random.default_rng(seed)
    n = 16384
    raw = rng.integers(0, 2**32, size=(n, ENTRY_BYTES // 4), dtype=np.uint32)
    makers = {
        "PianoPIR": lambda dev: PianoPIR(n, ENTRY_BYTES, raw, FAIL,
                                         device=dev),
        "SimpleBatchPianoPIR": lambda dev: SimpleBatchPianoPIR(
            n, ENTRY_BYTES, BATCH, raw, FAIL, device=dev),
        "FusedBatchPianoPIR": lambda dev: FusedBatchPianoPIR(
            n, ENTRY_BYTES, BATCH, raw, FAIL, device=dev)}
    for name, make in makers.items():
        pair = [make("cuda"), make("cpu")]
        for e in pair:
            e.preprocessing(rng=np.random.default_rng(seed + 1))
        check(same_clients(*pair), f"{name}: CUDA prep state differs from "
              "the CPU's")
        served = 0
        for step in range(40 if name == "PianoPIR" else 5):
            if name == "PianoPIR":
                idx = int(rng.integers(0, n))
                outs = []
                for e in pair:
                    try:
                        outs.append(e.query(idx))
                    except QueryError:
                        outs.append(None)
                same = (outs[0] is None and outs[1] is None) or (
                    outs[0] is not None and outs[1] is not None
                    and np.array_equal(*outs))
                served += outs[0] is not None
            else:
                ids = [int(i) for i in rng.integers(0, n, BATCH)]
                outs = [e.query(ids) for e in pair]
                same = np.array_equal(*outs)
                served += sum(np.array_equal(outs[0][r], raw[i])
                              for r, i in enumerate(ids))
            check(same and same_clients(*pair),
                  f"{name}: CUDA differs from the CPU at step {step}")
        check(served > 0, f"{name}: nothing served at the small size")
        print(f"host engine {name} at n={n}: CUDA state and answers equal "
              f"the CPU's over prep and {step + 1} steps ({served} served)")
        del pair


def host_prep_ms(prep, runs: int = 3) -> tuple[float, list]:
    """One warm prep, then `runs` timed ones (host clock; every prep ends
    in device-to-host copies, which synchronise): the min and all, ms."""
    import torch

    prep()
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prep()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return min(times), times


def host_batches(engine, raw: np.ndarray, rng, label: str) -> dict:
    """HOST_BATCHES batches of BATCH distinct uniform ids: every served row
    equals its raw row, every other row is zeros, and the served share is
    within 0.03 of the lossy FCFS model (params.expected_success_rate).
    Returns ms per batch and the success."""
    from pacmann_tpu_torch.pir.params import expected_success_rate

    n = raw.shape[0]
    P = engine.config.partition_num
    served, ms = 0, []
    for _ in range(HOST_BATCHES):
        ids = rng.choice(n, BATCH, replace=False)
        t0 = time.perf_counter()
        out = engine.query([int(i) for i in ids])
        ms.append((time.perf_counter() - t0) * 1e3)
        hit = (out == raw[ids]).all(axis=1)
        check(bool((hit | ~out.any(axis=1)).all()),
              f"{label}: a row is neither its raw row nor zeros")
        served += int(hit.sum())
    rate = served / (HOST_BATCHES * BATCH)
    model = expected_success_rate(BATCH, P, BATCH // P, FAIL)
    check(abs(rate - model) <= 0.03, f"{label}: success {rate:.4f} is not "
          f"within 0.03 of the model's {model:.4f}")
    return dict(batch_ms_median=float(np.median(ms)),
                batch_ms_mean=float(np.mean(ms)), success=rate,
                expected_success=model, batches=HOST_BATCHES)


def host_engines_phase(raw: np.ndarray, seed: int, reset,
                       counted) -> tuple[dict, dict]:
    """The host-state engines (pir/piano.py, pir/batch.py, pir/engine.py)
    at the main deployment, each DB freed before the next: first each on
    CUDA against the CPU at a small size (host_parity); then, with the
    launch counters set to 0 before each engine and read after it, and
    the wrappers' form rules spied on (form_spy):
      - PianoPIR over all N entries (C = 2,048, S = 492, T = 57,632): four
        preps (one warm), each K1 once and K7c once in its staged form,
        then HOST_QUERIES distinct uniform queries, each answered K7c once
        in its row form and equal to its raw row (a hint miss raises
        QueryError: at most 2^-FAIL + 0.03 of them);
      - SimpleBatchPianoPIR (16 PianoPIRs, C = 512, S = 124, T = 12,512):
        four preps, each partition's K1 and K7c staged, then HOST_BATCHES
        batches (host_batches), every sub-query a K7c row launch;
      - FusedBatchPianoPIR: four preps, each K1 once and K7b once in its
        staged form at (16, 12,512, 124), then HOST_BATCHES batches, each
        K2 once in its row-split form.
    Prints prep ms (min of 3 after the warm run), ms per query or batch,
    success and the phase's wall time. Returns (results, launches)."""
    import torch

    from pacmann_tpu_torch.pir.batch import SimpleBatchPianoPIR
    from pacmann_tpu_torch.pir.engine import FusedBatchPianoPIR
    from pacmann_tpu_torch.pir.piano import PianoPIR, QueryError

    t_phase = time.perf_counter()
    host_parity(seed)
    rng = np.random.default_rng(seed + 1)
    res, launches = {}, {}

    path = "host PianoPIR"
    print(f"-- path {path}")
    reset()
    with form_spy() as forms:
        t0 = time.perf_counter()
        pir = PianoPIR(N, ENTRY_BYTES, raw, FAIL)
        torch.cuda.synchronize()
        upload = time.perf_counter() - t0
        p = pir.params
        prep_ms, preps = host_prep_ms(
            lambda: pir.preprocessing(rng=np.random.default_rng(seed + 2)))
        ids = rng.choice(N, HOST_QUERIES, replace=False)
        errors, ms = 0, []
        for idx in ids:
            t0 = time.perf_counter()
            try:
                got = pir.query(int(idx))
            except QueryError:
                errors += 1
                continue
            ms.append((time.perf_counter() - t0) * 1e3)
            check(np.array_equal(got, raw[idx]),
                  f"{path}: query {idx} differs from its raw row")
    launches[path] = got = counted(path, ("aes_mmo_tables",
                                          "xor_scan_pallas"))
    answered = HOST_QUERIES - errors
    check(got["aes_mmo_tables"] == 4 and got["xor_scan_pallas"] == 4
          + answered, f"{path}: launches {got}, not 4 K1 and {4 + answered} "
          "K7c")
    check(dict(forms) == {("flat_form", "staged"): 4,
                          ("flat_form", "row"): answered},
          f"{path}: K7c forms {dict(forms)}")
    check(errors <= HOST_QUERIES * (2.0**-FAIL + 0.03),
          f"{path}: {errors} of {HOST_QUERIES} queries failed")
    res[path] = dict(upload_s=upload, prep_ms=prep_ms, prep_ms_all=preps,
                     query_ms_median=float(np.median(ms)),
                     query_ms_mean=float(np.mean(ms)),
                     success=answered / HOST_QUERIES, C=p.chunk_size,
                     S=p.set_size, T=p.primary_hint_num
                     + p.set_size * p.max_query_per_chunk)
    print(f"{path}: C={p.chunk_size} S={p.set_size} T={res[path]['T']}: "
          f"DB upload+pack {upload:.3f} s, prep {prep_ms:.2f} ms (min of 3; "
          f"{', '.join(f'{t:.2f}' for t in preps)}), query "
          f"{res[path]['query_ms_median']:.3f} ms median, {answered} of "
          f"{HOST_QUERIES} answered, each equal to its raw row")
    del pir
    torch.cuda.empty_cache()

    for path, cls, own in (
            ("host SimpleBatchPianoPIR", SimpleBatchPianoPIR,
             ("aes_mmo_tables", "xor_scan_pallas")),
            ("host FusedBatchPianoPIR", FusedBatchPianoPIR,
             ("aes_mmo_tables", "xor_hintgen_pallas", "xor_gather"))):
        print(f"-- path {path}")
        reset()
        with form_spy() as forms:
            t0 = time.perf_counter()
            e = cls(N, ENTRY_BYTES, BATCH, raw, FAIL)
            torch.cuda.synchronize()
            upload = time.perf_counter() - t0
            prep_ms, preps = host_prep_ms(
                lambda: e.preprocessing(rng=np.random.default_rng(seed + 3)))
            run = host_batches(e, raw, rng, path)
        launches[path] = got = counted(path, own)
        P = e.config.partition_num
        if cls is SimpleBatchPianoPIR:
            rows = forms[("flat_form", "row")]
            check(got["aes_mmo_tables"] == 4 * P
                  and got["xor_scan_pallas"] == 4 * P + rows
                  and dict(forms) == {("flat_form", "staged"): 4 * P,
                                      ("flat_form", "row"): rows},
                  f"{path}: launches {got}, forms {dict(forms)}")
        else:
            check(got["aes_mmo_tables"] == 4
                  and got["xor_hintgen_pallas"] == 4
                  and got["xor_gather"] == HOST_BATCHES
                  and dict(forms) == {("hintgen_form", "staged"): 4,
                                      ("gather_form", "row"): HOST_BATCHES},
                  f"{path}: launches {got}, forms {dict(forms)}")
        res[path] = dict(upload_s=upload, prep_ms=prep_ms,
                         prep_ms_all=preps, forms={
                             f"{r} {f}": c for (r, f), c in forms.items()},
                         **run)
        print(f"{path}: DB upload+pack {upload:.3f} s, prep {prep_ms:.2f} ms "
              f"(min of 3; {', '.join(f'{t:.2f}' for t in preps)}), batch "
              f"{run['batch_ms_median']:.3f} ms median, success "
              f"{run['success']:.4f} (model {run['expected_success']:.4f}), "
              "every served row equal to its raw row")
        del e
        torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t_phase
    print(f"host engines phase: {res['seconds']:.1f} s")
    return res, launches


def engine_phase(engine, raw: np.ndarray, seed: int, preps: int = 3,
                 batches: int = 10) -> dict:
    """Preprocessing (1 warm + `preps` timed) and `batches` timed 96-id
    batches after one warm batch."""
    engine.preprocessing(rng=np.random.default_rng(seed + 1))
    prep_s = []
    for i in range(preps):
        t0 = time.perf_counter()
        engine.preprocessing(rng=np.random.default_rng(seed + 2 + i))
        prep_s.append(time.perf_counter() - t0)
    rng = np.random.default_rng(seed + 3)
    n = raw.shape[0]
    engine.query([int(i) for i in rng.integers(0, n, 96)])     # warm
    done, lat = [], []
    for _ in range(batches):
        ids = [int(i) for i in rng.integers(0, n, 96)]
        t0 = time.perf_counter()
        out = engine.query(ids)
        lat.append(time.perf_counter() - t0)
        done.append((ids, out))
    exact = total = 0
    for ids, out in done:
        want = raw[ids]
        for r in range(len(ids)):
            total += 1
            if np.array_equal(out[r], want[r]):
                exact += 1
            else:
                check(not out[r].any(), f"row {ids[r]} answered wrongly")
    rate = exact / total
    print(f"engine prep s: {', '.join(f'{t:.4f}' for t in prep_s)} "
          f"(min {min(prep_s):.4f})")
    print(f"engine query batch96 ms: median {np.median(lat) * 1e3:.3f}, "
          f"min {min(lat) * 1e3:.3f}, max {max(lat) * 1e3:.3f} ({batches} "
          f"batches); "
          f"exact rows {exact}/{total} = {rate:.4f}; every other row zero")
    check(rate >= 0.98, f"batch-96 success {rate:.4f} < 0.98")
    return dict(prep_s=prep_s, batch96_ms=[t * 1e3 for t in lat],
                batch96_success=rate)


def fused_phase(fs, G: int, reps: int, seed: int) -> dict:
    """One warm and `reps` timed searches of a G-query group (20 steps,
    parallel 3), fetch success within 0.03 of the model."""
    rng = np.random.default_rng(seed)
    q = rng.random((G, DIM), dtype=np.float32)
    fs.search(q, k=10, max_step=20, parallel=3)                  # warm
    fs.maintenance_s = 0.0
    fs.refreshes = 0
    fs.fetch_stats[:] = 0
    comp = []
    for _ in range(reps):
        fs.ensure_budget(20, G, 3)
        t0 = time.perf_counter()
        ids = fs.search(q, k=10, max_step=20, parallel=3)
        comp.append(time.perf_counter() - t0 - fs.last_maintenance_s)
        check(ids.shape == (G, 10) and ((ids >= 0) & (ids < fs.n)).all(),
              f"group {G}: answers are not {G}x10 valid ids")
    ms_q = [c * 1e3 / G for c in comp]
    succ, bound = fused_fetch_check(fs, G, reps, f"group {G}")
    print(f"fused group {G}: ms/query median {np.median(ms_q):.3f}, min "
          f"{min(ms_q):.3f} ({reps} searches of 20 steps); maintenance "
          f"{fs.maintenance_s * 1e3 / (reps * G):.3f} ms/query over "
          f"{fs.refreshes} refreshes; fetch success {succ:.4f} vs bound "
          f"{bound:.4f}")
    return dict(ms_per_query=ms_q, fetch_success=succ, bound=bound,
                refreshes=fs.refreshes)


def int_vectors(rng, n: int) -> np.ndarray:
    """n vectors of SIFT1M's shape and value range: (n, 128) u8, 0-255."""
    return rng.integers(0, 256, (n, DIM), dtype=np.uint8)


def manifold_vectors(rng, basis: np.ndarray, n: int) -> np.ndarray:
    """n integer-valued vectors (u8, 0-255) near a 12-dimensional linear
    manifold of the 128 dimensions (basis (12, 128)): data a graph can
    navigate, as SIFT's low intrinsic dimension makes it."""
    ld = basis.shape[0]
    z = rng.standard_normal((n, ld), dtype=np.float32)
    return np.clip(np.rint(128 + 32 * (z @ basis) / np.sqrt(ld)), 0,
                   255).astype(np.uint8)


def l2_bound(Q: int, B: int, D: int) -> dict:
    """K6's bound: the products and norms as fp32 FMAs (2 flops each), the
    inputs read once and the (Q, B) output written once."""
    return bound(4 * (Q * D + B * D + Q * B),
                 flops=2 * Q * B * D + 2 * (Q + B) * D)


def compare_k6(seed: int) -> dict:
    """K6 against its plain version at the exact-search shape (1,000 x 1M x
    128) and at the shapes the plaintext paths launch: knn_search's
    (1,000, 65,536) block and (1,000, 16,960) tail and the kNN graph's
    (1,024, 65,536) block; at the cluster baseline's: k-means++ seeding's
    (1, 65,536) (one center against the sample), the Lloyd assignment's
    (65,536, 1,000) block and (16,960, 1,000) tail, the query routing's
    (64, 1,000) block and (40, 1,000) tail; also a ragged (1,000, 4,099) x
    D = 37 and a (999, 65,535) one whose rows are not 16-byte aligned (the
    kernel's 4-byte copies). Bit-equal on integer-valued data (0-255: every
    partial sum is exact), within 1e-5 (|q|^2 + |p|^2) elementwise on
    uniform [0, 1) floats. Timed on the floats in turns, kernel / plain /
    kernel; the plain version is itself the library (cuBLAS) form. Also
    timed: exact search's 16 K6 launches over 1M points alone."""
    import torch

    from pacmann_tpu_torch.graph.cluster import SEED_SAMPLE
    from pacmann_tpu_torch.ops import distance

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    tail = L2_N - L2_N // KNN_BLOCK * KNN_BLOCK
    # the cluster path's launches at n = N: sqrt(N) centroids, blocks of
    # CLUSTER_BLOCK vectors, of CLUSTER_QBLOCK of the L2_Q queries
    K = int(np.sqrt(N))
    lloyd_tail = N % CLUSTER_BLOCK or CLUSTER_BLOCK
    route_tail = L2_Q % CLUSTER_QBLOCK or CLUSTER_QBLOCK
    errs = {}
    for kind in ("integer", "float"):
        if kind == "integer":
            q, p = (torch.randint(0, 256, (rows, DIM), generator=gen,
                                  device="cuda").float()
                    for rows in (1024, L2_N))
        else:
            q, p = (torch.rand((rows, DIM), generator=gen, device="cuda")
                    for rows in (1024, L2_N))
        # the launch shapes, then a ragged one (D = 37: 4-byte copies) and
        # one whose rows are not 16-byte aligned (a view one float in)
        ragged = [x[:rows, :37].contiguous() for x, rows in ((q, L2_Q),
                                                            (p, 4099))]
        shifted = [x[:rows].reshape(-1)[1:1 + (rows - 1) * DIM].view(
            rows - 1, DIM) for x, rows in ((q, L2_Q), (p, KNN_BLOCK))]
        cluster_shapes = (
            (q[:1], p[:SEED_SAMPLE]), (p[:CLUSTER_BLOCK], q[:K]),
            (p[L2_N - lloyd_tail:], q[:K]), (q[:CLUSTER_QBLOCK], p[:K]),
            (q[:route_tail], p[:K]))
        for qs, ps in ((q[:L2_Q], p), (q[:L2_Q], p[:KNN_BLOCK]),
                       (q[:L2_Q], p[L2_N - tail:]), (q, p[:KNN_BLOCK]),
                       *cluster_shapes, ragged, shifted):
            got = distance.l2_distance_cuda(qs, ps)
            want = distance.l2_distance_plain(qs, ps)
            torch.cuda.synchronize()
            shape = f"({qs.shape[0]}, {ps.shape[0]}) x D = {qs.shape[1]}"
            if kind == "integer":
                check(torch.equal(got, want), f"K6 is not bit-equal to its "
                      f"plain version on integers at {shape}")
            diff = got.sub_(want).abs_()
            del want
            errs[kind] = max(errs.get(kind, 0.0), float(diff.max()))
            if kind == "float":
                scale = (qs * qs).sum(1)[:, None] + (ps * ps).sum(1)[None, :]
                check(bool((diff <= scale.mul_(1e-5)).all()),
                      f"K6 differs from its plain version by more than 1e-5 "
                      f"(|q|^2 + |p|^2) on floats at {shape} (max err "
                      f"{float(diff.max())})")
                del scale
            del got, diff
        del ragged, shifted
    torch.cuda.empty_cache()
    q = q[:L2_Q].contiguous()

    def k6():
        distance.l2_distance_cuda(q, p)

    def plain():
        distance.l2_distance_plain(q, p)

    def blocked():
        for b0 in range(0, L2_N, KNN_BLOCK):
            distance.l2_distance_cuda(q, p[b0:b0 + KNN_BLOCK])

    turns = [cuda_ms(fn, reps=5) for fn in (k6, plain, k6)]
    blocked_ms = cuda_ms(blocked, reps=3)
    ms = (turns[0] + turns[2]) / 2
    b = l2_bound(L2_Q, L2_N, DIM)
    tflops = 2 * L2_Q * L2_N * DIM / ms / 1e9
    print(f"K6 l2_distance ({L2_Q},{DIM})x({L2_N},{DIM}), the launch "
          f"shapes (1000|1024, {KNN_BLOCK}|{tail}), the cluster path's "
          f"(1, {SEED_SAMPLE}), ({CLUSTER_BLOCK}|{lloyd_tail}, {K}) and "
          f"({CLUSTER_QBLOCK}|{route_tail}, {K}), (1000, 4099) x D = 37 "
          f"and rows off 16-byte alignment: bit-equal to plain on "
          f"integer data; max err {errs['float']:.3g} on floats (within "
          f"1e-5 (|q|^2+|p|^2)); kernel {turns[0]:.3f}/{turns[2]:.3f} ms "
          f"({tflops:.1f} TFLOP/s), plain (cuBLAS form) {turns[1]:.3f} ms, "
          f"bound {b['bound_ms']:.3f} ms ({b['bound_by']}; the output alone "
          f"{4 * L2_Q * L2_N / HBM_BYTES_PER_S * 1e3:.3f} ms); in exact "
          f"search's {-(-L2_N // KNN_BLOCK)} blocks {blocked_ms:.3f} ms")
    return dict(max_abs_err=max(errs.values()), errs=errs, ms=ms,
                turns_ms=turns, plain_ms=turns[1], library_ms=turns[1],
                blocked_ms=blocked_ms, tflops=tflops, **b)


def exact_search_phase(seed: int) -> dict:
    """Exact search at full width through the port's entry: 1,000 queries
    over 1M integer-valued vectors, k = 10 (graph/recall.py::knn_search,
    what cli/exact_search.py runs). The ids through K6 equal those through
    the cuBLAS form (use_pallas=False) and, for 8 queries, a float64 scan's
    in stable order; then cli.exact_search.main once at -n 1000000
    -q 1000. Timed: the whole search (host clock, ending in the copy of
    the ids to the host); compare_k6 times its K6 launches alone."""
    import torch

    from pacmann_tpu_torch.cli import exact_search
    from pacmann_tpu_torch.graph.recall import knn_search

    rng = np.random.default_rng(seed)
    v = torch.from_numpy(int_vectors(rng, L2_N)).cuda().float()
    q = torch.from_numpy(int_vectors(rng, L2_Q)).cuda().float()
    ids = knn_search(v, q, 10)[1]
    check(torch.equal(ids, knn_search(v, q, 10, use_pallas=False)[1]),
          "exact search: the ids through K6 differ from the cuBLAS form's")
    v64 = v.double()
    for i in range(8):
        d64 = ((v64 - q[i].double()) ** 2).sum(1)
        check(torch.equal(ids[i], torch.sort(d64, stable=True).indices[:10]),
              f"exact search: query {i} differs from the float64 scan")
    del v64, d64
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        knn_search(v, q, 10)[1].cpu()
        times.append(time.perf_counter() - t0)
    med = float(np.median(times))
    print(f"exact search n={L2_N} q={L2_Q} k=10: ids through K6 == cuBLAS "
          f"form == float64 scan (8 queries); {med * 1e3 / L2_Q:.4f} ms/query"
          f", {L2_N * L2_Q / med / 1e9:.1f} G dist/s (median of 3: "
          + ", ".join(f"{t * 1e3:.2f}" for t in times) + " ms)")
    check(exact_search.main(["-n", str(L2_N), "-q", str(L2_Q)]) == 0,
          "cli.exact_search.main failed")
    return dict(batch_ms=[t * 1e3 for t in times],
                ms_per_query=med * 1e3 / L2_Q,
                gdist_per_s=L2_N * L2_Q / med / 1e9)


def plaintext_parity(seed: int) -> None:
    """PlaintextEngine on CUDA against the same code on the CPU: n = 65,536
    integer-valued vectors, a uniform random graph with 1 % all-zero rows
    (failed fetches), 200 queries, the same step randoms: ids and steps
    bit-equal, with benchmarking off and on; then search_paths_all over
    every vertex (4 steps, parallel 2), bit-equal."""
    import torch

    from pacmann_tpu_torch.graph.beam import PlaintextEngine, search_paths_all

    rng = np.random.default_rng(seed)
    n, Qn = 65_536, 200
    v = int_vectors(rng, n)
    g = rng.integers(0, n, (n, M)).astype(np.int32)
    g[rng.random(n) < 0.01] = 0
    q = int_vectors(rng, Qn)
    rand = rng.integers(0, n, (Qn, 20, 3, M)).astype(np.int32)
    prand = rng.integers(0, n, (n, 4, 2, M)).astype(np.int32)
    out = {}
    for dev in ("cuda", "cpu"):
        e = PlaintextEngine(v, g, device=dev)
        out[dev] = [*e.search(q, 10, 20, 3, step_randoms=rand),
                    *e.search(q, 10, 20, 3, step_randoms=rand,
                              benchmarking=True),
                    search_paths_all(e.vectors, e.graph, e.start_ids, prand,
                                     n=n, m=M, max_step=4, parallel=2,
                                     block=8192).cpu().numpy()]
    for name, a, b in zip(("ids", "steps", "benchmarking ids",
                           "benchmarking steps", "search_paths_all"),
                          out["cuda"], out["cpu"]):
        check(np.array_equal(a, b), f"plaintext parity: {name} differ "
              "between CUDA and the CPU")
    check((out["cuda"][0] >= 0).all(), "plaintext parity: empty answers")
    print(f"plaintext parity n={n}: CUDA == CPU (ids and steps of {Qn} "
          "queries, benchmarking off and on; search_paths_all over every "
          "vertex)")


def plaintext_phase(seed: int) -> dict:
    """The plaintext engine at full width: 1M integer-valued vectors of
    SIFT1M's shape, a uniform random graph of degree 32 (synth_raw's
    neighbour ids), 1,000 queries, k = 10, max_step 20, parallel 3
    (cli/ann.py's defaults): one warm and five timed batches (host clock;
    each ends in the answers' copy to the host), then recall@10 against
    brute_force_knn (K6). Recall is near 0 on a random graph: no limit."""
    from pacmann_tpu_torch.graph.beam import PlaintextEngine
    from pacmann_tpu_torch.graph.recall import brute_force_knn, compute_recall

    rng = np.random.default_rng(seed)
    v = int_vectors(rng, L2_N)
    g = rng.integers(0, L2_N, (L2_N, M))
    q = int_vectors(rng, L2_Q)
    engine = PlaintextEngine(v, g)
    check(engine.device.type == "cuda", "the engine did not go to CUDA")
    engine.search(q, 10, 20, 3, seed=seed)                       # warm
    lat = []
    for i in range(5):
        t0 = time.perf_counter()
        ids, steps = engine.search(q, 10, 20, 3, seed=seed + 1 + i)
        lat.append(time.perf_counter() - t0)
        check(ids.shape == (L2_Q, 10) and ((ids >= 0) & (ids < L2_N)).all(),
              "plaintext engine: answers are not 1000x10 valid ids")
    rec = compute_recall(brute_force_knn(engine.vectors, q, 10), ids, 10)
    med = float(np.median(lat))
    print(f"plaintext engine n={L2_N} m={M} q={L2_Q} (20 steps, parallel 3): "
          f"batch ms " + ", ".join(f"{t * 1e3:.2f}" for t in lat)
          + f"; median {med * 1e3 / L2_Q:.4f} ms/query; recall@10 "
          f"{rec:.4f} on a uniform random graph (no limit)")
    return dict(batch_ms=[t * 1e3 for t in lat],
                ms_per_query=med * 1e3 / L2_Q, recall=rec)


def exact_knn_graph(vt) -> np.ndarray:
    """The exact M-NN graph of the (n, DIM) tensor vt, self dropped (the
    farthest neighbour where a point has an equal twin before itself), by
    brute_force_knn on vt's device: (n, M) int64."""
    from pacmann_tpu_torch.graph.recall import brute_force_knn

    n = vt.shape[0]
    knn = brute_force_knn(vt, vt, M + 1)
    is_self = knn == np.arange(n)[:, None]
    is_self[~is_self.any(axis=1), -1] = True
    return knn[~is_self].reshape(n, M)


def knn_graph_phase(seed: int) -> dict:
    """Recall on a real graph: n = 131,072 integer-valued manifold vectors,
    their exact 32-NN graph (self dropped) from brute_force_knn through K6
    (about 4.4 TFLOP); PlaintextEngine's recall@10 on it must exceed recall
    on a uniform random graph of the same degree by at least 0.2 (the twin
    of test_built_graph_beats_random_graph)."""
    import torch

    from pacmann_tpu_torch.graph.beam import PlaintextEngine
    from pacmann_tpu_torch.graph.recall import brute_force_knn, compute_recall

    rng = np.random.default_rng(seed)
    basis = rng.standard_normal((12, DIM), dtype=np.float32)
    vt = torch.from_numpy(manifold_vectors(rng, basis, KNN_N)).cuda().float()
    q = manifold_vectors(rng, basis, L2_Q)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    graph = exact_knn_graph(vt)
    build_s = time.perf_counter() - t0
    gnd = brute_force_knn(vt, q, 10)
    rec = {}
    for name, gr in (("knn", graph),
                     ("random", rng.integers(0, KNN_N, (KNN_N, M)))):
        ids, _ = PlaintextEngine(vt, gr).search(q, 10, 20, 3, seed=seed)
        rec[name] = compute_recall(gnd, ids, 10)
    print(f"kNN graph n={KNN_N} m={M}: built in {build_s:.3f} s "
          f"({2 * KNN_N ** 2 * DIM / build_s / 1e12:.1f} TFLOP/s end to end, "
          f"top-k included); recall@10 {rec['knn']:.4f} on it vs "
          f"{rec['random']:.4f} on a random graph")
    check(rec["knn"] >= rec["random"] + 0.2,
          f"kNN-graph recall {rec['knn']:.4f} is not 0.2 above the random "
          f"graph's {rec['random']:.4f}")
    return dict(build_s=build_s, recall_knn=rec["knn"],
                recall_random=rec["random"])


# the private driver (pacmann_tpu_torch/private/driver.py) at
# scripts/run-private-search.sh's deployment: n = N, d = DIM, m = M (640 B
# entries), k = 10, step 20, parallel 3, rtt 50 ms, FailureProbLog2 8;
# each run's q is the only cut. (label, engine, protocol route, q,
# concurrent, non_private, profiled); the route is the device engines'
# ($PACMANN_PROTOCOL_ROUTE: "fused" runs K3, "pallas" K4). The first run
# builds the graph; "device-fused", "fused concurrent" and "non_private"
# answer the same 100 queries (the recall comparison)
PRIVATE_K, PRIVATE_STEP, PRIVATE_PARALLEL, PRIVATE_RTT = 10, 20, 3, 50.0
PRIVATE_RUNS = (
    ("device-fused", "device-fused", "fused", 100, 8, False, False),
    ("device", "device", "pallas", 20, 1, False, False),
    ("fused", "fused", None, 20, 1, False, False),
    ("fused concurrent", "fused", None, 100, 8, False, False),
    ("fused profiled", "fused", None, 2, 1, False, True),
    ("simple", "simple", None, 10, 1, False, False),
    ("non_private", "device-fused", None, 100, 8, True, False),
)


def private_quotas(P: int) -> tuple:
    """The sub-queries a partition that K2, K3 and K4 see in a round of
    each device-engine run of PRIVATE_RUNS over P partitions: a step's
    group x PRIVATE_PARALLEL x M ids over P ("device" queries one beam at
    a time, group 1)."""
    return tuple(sorted({(group if engine == "device-fused" else 1)
                         * PRIVATE_PARALLEL * M // P
                         for _, engine, _, _, group, non_private, _
                         in PRIVATE_RUNS
                         if engine.startswith("device") and not non_private}))


# CUDA against the CPU (PRIVATE_SMALL_Q queries of PRIVATE_SMALL_STEP
# steps: the CPU side takes most of the phase), the graph build's and the
# cluster baseline's too, and the CLI: n = 16,384 integer-valued vectors
PRIVATE_SMALL_N, PRIVATE_SMALL_Q, PRIVATE_SMALL_STEP = 16_384, 3, 10
# the build's data: manifold vectors (u8, rint-quantised and clipped) of
# BUILD_LATENT latent dimensions for the driver's cell and HARD_LATENT for
# the harder cell. Not the JAX package's continuum workloads (f32 at unit
# scale with 0.02 ambient noise, built with 8 rounds, not 6), so its
# RESULTS.md rows are context, not yardsticks
BUILD_LATENT, HARD_LATENT = 8, 12
# the harder cell's bars, from its own readings (scripts/build_quality.py
# over seeds 5-8 on the H100: gate 0.95-0.98, recall@10 0.8535-0.8652):
# the lowest gate hit rate - 0.04, the lowest plaintext recall@10 - 0.02
HARD_GATE_MIN, HARD_RECALL_MIN = 0.91, 0.8335
# the built graph's checks: the gate's self-query hit rate, private
# recall against non-private's, the plaintext engine's recall against a
# random graph's
BUILD_GATE_MIN, PRIVATE_RECALL_GAP, BUILT_OVER_RANDOM = 0.95, 0.05, 0.2
# the cluster baseline: sqrt(n) clusters (cluster-search.py:92), Lloyd
# iterations, kmeans's block and the searcher's query block
CLUSTER_ITERS, CLUSTER_BLOCK, CLUSTER_QBLOCK = 10, 65536, 64
# the cluster parity's data: well-separated integer clusters
PARITY_CLUSTERS = 128
# K2's row-split kernel, the fused engine's batch scan, as a trace names it
K2_ROW_KERNEL = "row_split_kernel"


@contextlib.contextmanager
def protocol_route(route):
    """$PACMANN_PROTOCOL_ROUTE set to `route` (None: unset) while the block
    runs, restored on leaving."""
    saved = os.environ.pop("PACMANN_PROTOCOL_ROUTE", None)
    if route is not None:
        os.environ["PACMANN_PROTOCOL_ROUTE"] = route
    try:
        yield
    finally:
        os.environ.pop("PACMANN_PROTOCOL_ROUTE", None)
        if saved is not None:
            os.environ["PACMANN_PROTOCOL_ROUTE"] = saved


@contextlib.contextmanager
def pinned_randbits(start: int):
    """secrets.randbits as a counter from `start` while the block runs: the
    host engines re-key a refresh from it, so two runs see the same keys."""
    import itertools
    import secrets

    saved = secrets.randbits
    seq = itertools.count(start)
    secrets.randbits = lambda k: next(seq)
    try:
        yield
    finally:
        secrets.randbits = saved


@contextlib.contextmanager
def fused_searches():
    """Records the FusedPrivateSearch objects made while the block runs
    (the driver's device-fused search, for its fetch counters)."""
    from pacmann_tpu_torch.private import fused_search

    made = []
    cls = fused_search.FusedPrivateSearch

    class Recorded(cls):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    fused_search.FusedPrivateSearch = Recorded
    try:
        yield made
    finally:
        fused_search.FusedPrivateSearch = cls


def private_config(**kw):
    """The driver's config at the canonical flags, `kw` on top."""
    from pacmann_tpu_torch.private.driver import PrivateSearchConfig

    base = dict(dim=DIM, m=M, k=PRIVATE_K, max_step=PRIVATE_STEP,
                parallel=PRIVATE_PARALLEL, rtt_ms=PRIVATE_RTT,
                failure_prob_log2=FAIL, build_graph=False)
    return PrivateSearchConfig(**{**base, **kw})


def numpy_step_randoms(cfg):
    """A step_randoms_fn for the driver: each device-fused search's step
    randoms from np.random.default_rng(seed), the same on every device."""
    from pacmann_tpu_torch.pir.params import (derive_batch_params,
                                              derive_piano_params)

    c = derive_batch_params(cfg.n, 4 * (cfg.dim + cfg.m), cfg.m,
                            cfg.failure_prob_log2)
    p = derive_piano_params(c.partition_size, 4 * (cfg.dim + cfg.m),
                            cfg.failure_prob_log2)
    P = c.partition_num

    def draw(seed, Qn):
        r = np.random.default_rng(seed)
        quota = Qn * cfg.parallel * cfg.m // P
        return (r.integers(0, cfg.n, (cfg.max_step, Qn, cfg.parallel, cfg.m),
                           dtype=np.int32),
                r.integers(0, p.chunk_size, (cfg.max_step, quota, P,
                                             p.set_size), dtype=np.int32))
    return draw


def fused_fetch_check(fs, group: int, searches: int, label: str) -> tuple:
    """A device-fused search's fetch success over `searches` searches of
    `group` queries and PRIVATE_STEP steps each, within 0.03 of
    expected_success_rate at its wanted fetches a step and quota. Returns
    (success, bound)."""
    from pacmann_tpu_torch.pir.params import expected_success_rate

    P = fs.engine.config.partition_num
    quota = group * PRIVATE_PARALLEL * M // P
    want_step = int(round(fs.fetch_stats[0] / (searches * PRIVATE_STEP)))
    bound = expected_success_rate(want_step, P, quota, FAIL)
    succ = fs.fetch_success_rate()
    check(abs(succ - bound) <= 0.03, f"{label}: fetch success {succ:.4f} "
          f"is not within 0.03 of the bound {bound:.4f}")
    return succ, bound


def private_parity(seed: int, v: np.ndarray, graph: np.ndarray) -> None:
    """run_private_search on CUDA against the CPU (plain versions) at n =
    PRIVATE_SMALL_N on every engine: the same answers, reach steps and
    success rate. "device" on route "pallas" (K4), "device-fused" on
    "fused" (K3), both with the same step randoms (numpy_step_randoms); the
    host engines' refresh keys pinned (pinned_randbits)."""
    from pacmann_tpu_torch.private import driver

    rng = np.random.default_rng(seed)
    q = int_vectors(rng, PRIVATE_SMALL_Q).astype(np.float32)
    n = v.shape[0]
    cases = (("simple", dict(engine="simple"), None),
             ("fused", dict(engine="fused"), None),
             ("device", dict(engine="device"), "pallas"),
             ("device-fused", dict(engine="device-fused"), "fused"),
             ("device-fused concurrent",
              dict(engine="device-fused", concurrent=8), "fused"),
             ("fused concurrent", dict(engine="fused", concurrent=8), None),
             ("device-fused benchmarking",
              dict(engine="device-fused", benchmarking=True), "fused"))
    for label, kw, route in cases:
        out = {}
        for dev in ("cuda", "cpu"):
            cfg = private_config(n=n, q=len(q), seed=seed, device=dev,
                                 max_step=PRIVATE_SMALL_STEP, **kw)
            fn = (numpy_step_randoms(cfg) if cfg.engine == "device-fused"
                  else None)
            t0 = time.perf_counter()
            with protocol_route(route), pinned_randbits(seed):
                out[dev] = driver.run_private_search(cfg, v, graph, q,
                                                     step_randoms_fn=fn)
            out[dev + " s"] = time.perf_counter() - t0
        a, b = out["cuda"], out["cpu"]
        check(np.array_equal(a.answers, b.answers)
              and np.array_equal(a.reach_steps, b.reach_steps)
              and a.success_rate == b.success_rate,
              f"private parity {label}: CUDA differs from the CPU")
        if not kw.get("benchmarking"):
            check((a.answers >= 0).mean() > 0.9,
                  f"private parity {label}: answers missing")
        print(f"private parity {label} n={n} q={len(q)}: CUDA == CPU "
              f"(answers, reach steps, success {a.success_rate:.4f}); "
              f"{out['cuda s']:.2f} s on CUDA, {out['cpu s']:.2f} s on the "
              "CPU")


def private_run_line(label: str, cfg, res, got: dict, extra: str) -> dict:
    r = res.report
    row = dict(q=cfg.q, concurrent=cfg.concurrent, prep_s=res.prep_time_s,
               avg_compute_s_per_q=res.avg_query_time_s,
               maintenance_s=res.maintenance_time_s,
               success=res.success_rate, window=r.window_size,
               storage_mb=r.storage_bytes / 2**20,
               extra_storage_mb=r.extra_storage_bytes / 2**20,
               offline_comm_per_batch_b=r.offline_comm_per_batch_bytes,
               online_comm_per_batch_b=r.online_comm_per_batch_bytes,
               launches={k: c for k, c in got.items() if c})
    print(f"private {label} n={cfg.n} q={cfg.q} concurrent={cfg.concurrent}"
          f": prep {res.prep_time_s:.4f} s, avg compute "
          f"{res.avg_query_time_s:.5f} s/query, maintenance "
          f"{res.maintenance_time_s:.4f} s, {extra}; report: window "
          f"{r.window_size}, storage {row['storage_mb']:.3f} MB, extra "
          f"{row['extra_storage_mb']:.3f} MB, offline comm/batch "
          f"{r.offline_comm_per_batch_bytes} B, online comm/batch "
          f"{r.online_comm_per_batch_bytes} B; launches {row['launches']}")
    return row


def trace_device(path) -> tuple[float, list]:
    """From a Chrome trace of torch.profiler: the device's busy time in s
    (the union of its kernel, copy and set intervals) and the names of the
    kernels it ran."""
    events = [e for e in json.loads(Path(path).read_text())["traceEvents"]
              if e.get("ph") == "X" and "dur" in e]
    dev = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                 for e in events if e.get("cat") in (
                     "kernel", "gpu_memcpy", "gpu_memset"))
    busy_us, end = 0.0, -1.0
    for a, b in dev:
        busy_us += max(0.0, b - max(a, end))
        end = max(end, b)
    names = [e["name"] for e in events if e.get("cat") == "kernel"]
    return busy_us * 1e-6, names


def write_bvecs(path, mat: np.ndarray) -> None:
    """(n, d) u8 rows as a .bvecs file: each row a little-endian i32 d,
    then its d bytes."""
    n, d = mat.shape
    rows = np.empty((n, 4 + d), np.uint8)
    rows[:, :4] = np.frombuffer(np.int32(d).tobytes(), np.uint8)
    rows[:, 4:] = mat
    rows.tofile(path)


def graph_invariants(graph: np.ndarray, n: int, label: str) -> None:
    """Every row of graph holds exactly M distinct non-self ids in [0, n)."""
    check(graph.shape == (n, M), f"{label}: graph is {graph.shape}")
    check(bool(((graph >= 0) & (graph < n)).all()),
          f"{label}: ids outside [0, {n})")
    srt = np.sort(graph, axis=1)
    check(bool((srt[:, 1:] != srt[:, :-1]).all()),
          f"{label}: a row repeats an id")
    check(not (graph == np.arange(n)[:, None]).any(),
          f"{label}: a row holds its own id")


def _to_cuda(x):
    import torch

    if isinstance(x, torch.Tensor):
        return x.cuda()
    if isinstance(x, dict):
        return {k: _to_cuda(v) for k, v in x.items()}
    return x


def build_parity(seed: int) -> dict:
    """graph/build.py on CUDA against the CPU at n = PRIVATE_SMALL_N
    integer-valued manifold vectors (every f32 distance exact), build_graph's
    defaults, the same seed. The CPU build makes its draws on the CPU and
    keeps them, and records each stage's inputs and output; each stage is
    replayed on the card from those inputs: the integer stages (descent
    rounds, wide round, prunes, corridors, degree regularization and fill)
    bit-equal. The bootstrap and the ladder rank by float centroids
    (means), so they may differ at a near-tie: their differing rows are
    counted. Then the whole build on the card with the CPU's draws handed
    in: the same graph, or its differing rows counted and a float stage's
    difference named as their cause; and with the card's own draws (the
    counter hash on the card): the same graph as with the CPU's."""
    import torch

    from pacmann_tpu_torch.graph import build

    rng = np.random.default_rng(seed)
    basis = rng.standard_normal((BUILD_LATENT, DIM), dtype=np.float32)
    v = manifold_vectors(rng, basis, PRIVATE_SMALL_N)
    rec = {}
    cpu_draws = build.BuildDraws(seed, keep=True)
    t0 = time.perf_counter()
    g_cpu = build.build_graph(v, M, seed=seed, device="cpu", draws=cpu_draws,
                              record=rec)
    cpu_s = time.perf_counter() - t0
    made = cpu_draws.made()
    stages = {}
    for name, (fn, args, kw, out) in rec.items():
        got = fn(*[_to_cuda(a) for a in args], **kw)
        outs = out if isinstance(out, tuple) else (out,)
        gots = got if isinstance(got, tuple) else (got,)
        rows = 0
        for a, b in zip(outs, gots):
            b = b.cpu()
            same = (a == b) if a.dtype != torch.float32 else (
                (a == b) | (torch.isinf(a) & torch.isinf(b)))
            if same.dim() > 1:
                same = same.reshape(same.shape[0], -1).all(dim=1)
            rows = max(rows, int((~same).sum()))
        stages[name] = rows
    del rec
    float_stages = ("bootstrap", "ladder")
    bad = {k: r for k, r in stages.items() if r and k not in float_stages}
    check(not bad, f"build parity: integer stages differ between CUDA and "
          f"the CPU (rows): {bad}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    g_cuda = build.build_graph(v, M, seed=seed, draws=made)
    cuda_s = time.perf_counter() - t0
    graph_invariants(g_cuda, PRIVATE_SMALL_N, "build parity (CUDA)")
    differ = int((g_cpu != g_cuda).any(axis=1).sum())
    cause = [k for k in float_stages if stages[k]]
    check(differ == 0 or cause, f"build parity: {differ} rows differ with "
          "every stage equal on replay")
    t0 = time.perf_counter()
    g_own = build.build_graph(v, M, seed=seed)
    own_s = time.perf_counter() - t0
    check(np.array_equal(g_own, g_cuda), "build parity: the card's own "
          "draws build another graph than the CPU's draws handed in")
    print(f"build parity n={PRIVATE_SMALL_N}: every integer stage bit-equal "
          f"on CUDA replay ({len(stages)} stages); float stages' differing "
          f"rows {({k: stages[k] for k in float_stages})}; whole graph with "
          f"the CPU's {len(made)} draws handed in: {differ} rows differ"
          + (f" (cause: {', '.join(cause)})" if differ else "")
          + f"; with the card's own draws the same graph; CPU {cpu_s:.2f} s, "
          f"CUDA {cuda_s:.2f} s, {own_s:.2f} s")
    return dict(stage_rows=stages, graph_rows=differ, cpu_s=cpu_s,
                cuda_s=cuda_s, own_draws_s=own_s)


def cluster_parity(seed: int) -> dict:
    """graph/cluster.py on CUDA (K6 routing and assignment) against the CPU
    at n = PRIVATE_SMALL_N integer-valued vectors in PARITY_CLUSTERS
    well-separated clusters (the centroids exact means, no argmin near a
    tie), the same seeding ids (drawn once): labels, centroids and search
    ids of 1,000 queries equal."""
    from pacmann_tpu_torch.graph import cluster

    rng = np.random.default_rng(seed)
    per = PRIVATE_SMALL_N // PARITY_CLUSTERS
    centers = rng.integers(0, 32, (PARITY_CLUSTERS, DIM)) * 6
    v = (np.repeat(centers, per, axis=0)
         + rng.integers(0, 4, (PRIVATE_SMALL_N, DIM))).astype(np.float32)
    q = v[rng.choice(PRIVATE_SMALL_N, L2_Q, replace=False)] + 1
    import torch

    ids = cluster._kmeanspp_init(torch.from_numpy(v), PARITY_CLUSTERS,
                                 seed=seed)
    out = {}
    for dev in ("cuda", "cpu"):
        s = cluster.ClusterSearcher(v, PARITY_CLUSTERS, CLUSTER_ITERS, seed,
                                    init_ids=ids.numpy(), device=dev)
        out[dev] = (s.labels, s.centroids, s.search(q, PRIVATE_K))
    a, b = out["cuda"], out["cpu"]
    check(all(np.array_equal(x, y) for x, y in zip(a, b)),
          "cluster parity: labels, centroids or search ids differ between "
          "CUDA and the CPU")
    print(f"cluster parity n={PRIVATE_SMALL_N} K={PARITY_CLUSTERS}: CUDA == "
          f"CPU (labels, centroids, ids of {L2_Q} queries)")
    return dict(equal=True)


def built_graph_phase(vt, queries: np.ndarray, graph: np.ndarray,
                      seed: int) -> tuple[dict, np.ndarray]:
    """The plaintext engine on the driver's built graph: recall@10 over the
    L2_Q queries (step 20, parallel 3; ground truth through K6, one launch
    a block of KNN_BLOCK points) at least BUILT_OVER_RANDOM above a random
    graph's of degree M. Returns (results, the ground truth)."""
    from pacmann_tpu_torch.graph.beam import PlaintextEngine
    from pacmann_tpu_torch.graph.recall import brute_force_knn, compute_recall

    n = vt.shape[0]
    gnd = brute_force_knn(vt, queries, 10)
    rng = np.random.default_rng(seed)
    rec = {}
    for name, gr in (("built", graph), ("random",
                                        rng.integers(0, n, (n, M)))):
        t0 = time.perf_counter()
        ids, _ = PlaintextEngine(vt, gr).search(queries, 10, 20, 3,
                                                seed=seed)
        rec[name] = compute_recall(gnd, ids, 10)
        rec[name + " ms/query"] = (time.perf_counter() - t0) * 1e3 / len(
            queries)
    print(f"built graph n={n} m={M}: plaintext recall@10 {rec['built']:.4f} "
          f"({len(queries)} queries, step 20, parallel 3) vs "
          f"{rec['random']:.4f} on a random graph")
    check(rec["built"] >= rec["random"] + BUILT_OVER_RANDOM,
          f"built-graph recall {rec['built']:.4f} is not {BUILT_OVER_RANDOM} "
          f"above the random graph's {rec['random']:.4f}")
    from pacmann_tpu_torch.graph.recall import Q_BLOCK

    return dict(rec, k6_launches=-(-n // KNN_BLOCK) * -(-len(queries)
                                                         // Q_BLOCK)), gnd


def cluster_phase(vt, queries: np.ndarray, gnd: np.ndarray,
                  seed: int) -> dict:
    """The cluster baseline on the same vectors: ClusterSearcher with
    sqrt(n) clusters and CLUSTER_ITERS Lloyd iterations, then the L2_Q
    queries; train s, ms/query and recall@10 against `gnd` (the exact
    ground truth of the built-graph path). Its K6 launches: one a seeding
    center, one a CLUSTER_BLOCK block a Lloyd iteration, one a block of
    CLUSTER_QBLOCK queries."""
    import torch

    from pacmann_tpu_torch.graph.cluster import ClusterSearcher
    from pacmann_tpu_torch.graph.recall import compute_recall

    n = vt.shape[0]
    searcher = ClusterSearcher(vt, None, CLUSTER_ITERS, seed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ids = searcher.search(queries, 10)
    search_s = time.perf_counter() - t0
    K = int(np.sqrt(n))
    want = (K + CLUSTER_ITERS * -(-n // CLUSTER_BLOCK)
            + -(-len(queries) // CLUSTER_QBLOCK))
    rec = compute_recall(gnd, ids, 10)
    print(f"cluster baseline n={n} K={K} iters={CLUSTER_ITERS}: train "
          f"{searcher.train_time:.3f} s, "
          f"{search_s * 1e3 / len(queries):.4f} ms/query ({len(queries)} "
          f"queries), recall@10 {rec:.4f}; K6 launches {want} ({K} seeding "
          f"+ {CLUSTER_ITERS} x {-(-n // CLUSTER_BLOCK)} Lloyd + "
          f"{-(-len(queries) // CLUSTER_QBLOCK)} routing)")
    return dict(clusters=K, iters=CLUSTER_ITERS, train_s=searcher.train_time,
                ms_per_query=search_s * 1e3 / len(queries), recall=rec,
                k6_launches=want)


def hard_latent_phase(seed: int) -> dict:
    """The build on the harder workload: N manifold vectors of HARD_LATENT
    dimensions, build_graph called directly (its defaults, the gate on),
    then built_graph_phase and cluster_phase on it. Its bars come from its
    own readings over several seeds (scripts/build_quality.py): the gate's
    hit rate at least HARD_GATE_MIN, plaintext recall@10 at least
    HARD_RECALL_MIN."""
    import torch

    from pacmann_tpu_torch.graph import build

    rng = np.random.default_rng(seed)
    basis = rng.standard_normal((HARD_LATENT, DIM), dtype=np.float32)
    v = manifold_vectors(rng, basis, N)
    q = manifold_vectors(rng, basis, L2_Q).astype(np.float32)
    last = {}
    graph = build.build_graph(v, M, seed=seed, quality_gate=True, stats=last)
    graph_invariants(graph, N, f"the latent-{HARD_LATENT} graph")
    vt = torch.from_numpy(v).cuda().float()
    built, gnd = built_graph_phase(vt, q, graph, seed)
    clus = cluster_phase(vt, q, gnd, seed)
    hit, steps = last["gate"]
    print(f"latent {HARD_LATENT} n={N}: build {last['seconds']:.2f} s "
          f"(draws {last['draw_seconds']:.2f} s, peak "
          f"{last['peak_gb']:.2f} GB), gate hit rate {hit:.3f} (bar "
          f"{HARD_GATE_MIN}), avg steps {steps:.2f}; plaintext recall@10 "
          f"{built['built']:.4f} (bar {HARD_RECALL_MIN}), cluster "
          f"{clus['recall']:.4f}")
    check(hit >= HARD_GATE_MIN, f"latent {HARD_LATENT}: the gate's hit rate "
          f"{hit:.3f} is below {HARD_GATE_MIN}")
    check(built["built"] >= HARD_RECALL_MIN, f"latent {HARD_LATENT}: "
          f"plaintext recall@10 {built['built']:.4f} is below "
          f"{HARD_RECALL_MIN}")
    return dict(build_s=last["seconds"], draw_seconds=last["draw_seconds"],
                phases=dict(last["phases"]),
                phase_draw_seconds=dict(last["phase_draw_seconds"]),
                gate_hit_rate=hit, gate_avg_steps=steps, built=built,
                cluster=clus,
                k6_launches=built["k6_launches"] + clus["k6_launches"])


def build_phase_check(last: dict, cache: Path, run_s: float,
                      load_int_matrix) -> dict:
    """The driver's graph build at full width (the first private run):
    the graph cached at `cache` with its aux record, every row M distinct
    non-self ids, the gate's hit rate at least BUILD_GATE_MIN; prints the
    build's wall time, each phase's seconds, the draws' and the card's
    peak memory (`last`: the run's PrivateSearchResult.build_stats)."""
    check(cache.exists(), f"the driver did not cache the graph at {cache}")
    aux = cache.with_name(cache.stem + "_aux.txt").read_text().splitlines()
    check(len(aux) == 3 and aux[0] == f"Dataset: manifold_{N}_{DIM}_{M}"
          and aux[1].startswith("Graph generation time: ")
          and aux[2] == f"n={N} dim={DIM} m={M}",
          f"the aux record is not the reference's three lines: {aux}")
    graph = load_int_matrix(str(cache), N, M)
    graph_invariants(graph, N, "the built graph")
    hit, steps = last["gate"]
    phases, draws = last["phases"], last["phase_draw_seconds"]
    print(f"graph build n={N} m={M} (rounds 6, keep_nearest 16, corridor "
          f"16:2:1): {last['seconds']:.2f} s in all ({run_s:.2f} s for the "
          f"whole driver run), draws {last['draw_seconds']:.2f} s, peak "
          f"{last['peak_gb']:.2f} GB; phases (draws inside): "
          + ", ".join(f"{k} {v:.3f}" + (f" ({draws[k]:.3f})"
                                        if draws.get(k, 0.0) >= 0.001 else "")
                      for k, v in phases.items())
          + f"; gate hit rate {hit:.3f}, avg steps {steps:.2f}; every row "
          f"{M} distinct non-self ids")
    check(hit >= BUILD_GATE_MIN, f"the gate's hit rate {hit:.3f} is below "
          f"{BUILD_GATE_MIN}")
    return dict(seconds=last["seconds"], run_s=run_s,
                draw_seconds=last["draw_seconds"], peak_gb=last["peak_gb"],
                phases=dict(phases),
                phase_draw_seconds=dict(last["phase_draw_seconds"]),
                gate_hit_rate=hit, gate_avg_steps=steps,
                aux=aux)


def private_search_phase(seed: int, reset, counted) -> tuple[dict, dict]:
    """The private driver, run_private_search, the way a user runs it:
      1. private_parity: every engine on CUDA against the CPU at n =
         PRIVATE_SMALL_N (integer-valued vectors, their exact M-NN graph);
         build_parity and cluster_parity, the graph build and the cluster
         baseline the same way;
      2. the canonical deployment at full width (N x 640 B): N manifold
         vectors (u8, SIFT1M's shape, BUILD_LATENT latent dimensions) in
         a .bvecs file in a temporary
         directory and L2_Q manifold queries; each of PRIVATE_RUNS with the
         launch counters set to 0 just before and read just after, each
         engine's DB freed before the next, given the input file, the
         queries and their exact ground truth and no graph: the first run
         builds the graph (build_graph=True, verbose: the gate on), caches
         it under the reference's name and writes the aux record, the later
         runs load it. Checks: the cache and the aux record, every row M
         distinct non-self ids, the gate's hit rate at least
         BUILD_GATE_MIN; per run the exact kernels of its engine (simple:
         K1 and K7c; fused: K1, K7b and K2; device and device-fused: K1, K2
         and the route's K4 or K3; non_private: its engine's prep only
         (JAX's PIRGraphOracle preprocesses in non-private mode too) and no
         kernel in the query loop; the build launches none), success
         within 0.03 of expected_success_rate (device-fused's fetch
         counters) or above 0.7; "fused profiled" traces its query loop
         (-profile): the device's time a query from the trace over the
         unprofiled "fused" run's compute time a query is the device's
         busy share (the profiler slows the host);
      3. recall on the built graph: "device-fused" and "fused concurrent"
         recall@10 at least non-private recall - PRIVATE_RECALL_GAP (the
         same 100 queries, graph and seed); the path "built graph": the
         plaintext engine's recall@10 over L2_Q queries (step 20, parallel
         3; ground truth through K6) at least BUILT_OVER_RANDOM above a
         random graph's of degree M; the path "cluster": ClusterSearcher on
         the same vectors (sqrt(N) clusters, CLUSTER_ITERS iterations),
         train s, ms/query and recall@10, its K6 launches exact; the
         path "latent 12": hard_latent_phase;
      4. cli.private_search.main once at n = PRIVATE_SMALL_N with -input,
         -graph, -report and -profile: the report file holds every field,
         the trace names K2's batch kernel.
    Returns (results, launches)."""
    import math
    import shutil
    import tempfile

    import torch

    from pacmann_tpu_torch.cli import private_search as cli
    from pacmann_tpu_torch.graph.recall import brute_force_knn
    from pacmann_tpu_torch.io.loaders import load_int_matrix, save_int_matrix
    from pacmann_tpu_torch.io.report import PrivateSearchReport
    from pacmann_tpu_torch.private import driver

    t_phase = time.perf_counter()
    res, launches = {}, {}
    rng = np.random.default_rng(seed)
    small_v = torch.from_numpy(int_vectors(rng, PRIVATE_SMALL_N)).cuda()
    small_v = small_v.float()
    small_g = exact_knn_graph(small_v)
    small_v = small_v.cpu().numpy()
    private_parity(seed + 1, small_v, small_g)
    res["build_parity"] = build_parity(seed + 3)
    res["cluster_parity"] = cluster_parity(seed + 4)

    # 2. the canonical deployment on the graph the driver builds
    out_dir = Path("chiprun_out")
    prof_dir = out_dir / "private_profile"
    shutil.rmtree(prof_dir, ignore_errors=True)
    rng = np.random.default_rng(seed + 2)
    basis = rng.standard_normal((BUILD_LATENT, DIM), dtype=np.float32)
    t0 = time.perf_counter()
    vectors = manifold_vectors(rng, basis, N)
    queries = manifold_vectors(rng, basis, L2_Q).astype(np.float32)
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    bvecs = Path(tmp.name) / "manifold.bvecs"
    write_bvecs(bvecs, vectors)
    vt = torch.from_numpy(vectors).cuda().float()
    gnd = brute_force_knn(vt, queries, PRIVATE_K)
    print(f"private inputs n={N}: manifold vectors and {L2_Q} queries, "
          f"{bvecs.stat().st_size / 1e6:.1f} MB .bvecs, ground truth "
          f"{time.perf_counter() - t0:.2f} s")
    cache = Path(tmp.name) / f"manifold_{N}_{DIM}_{M}_graph.npy"
    own_of = {"simple": ("aes_mmo_tables", "xor_scan_pallas"),
              "fused": ("aes_mmo_tables", "xor_hintgen_pallas",
                        "xor_gather"),
              "pallas": ("aes_mmo_tables", "xor_gather", "claim_select"),
              "fused route": ("aes_mmo_tables", "xor_gather",
                              "select_full")}
    for i, (label, engine, route, q, group, non_private,
            profiled) in enumerate(PRIVATE_RUNS):
        path = f"private {label}"
        print(f"-- path {path}")
        cfg = private_config(n=N, q=q, seed=seed, engine=engine,
                             concurrent=group, non_private=non_private,
                             profile_dir=str(prof_dir) if profiled else "",
                             input_file=str(bvecs), build_graph=True,
                             verbose=i == 0)
        check(i == 0 or cache.exists(), f"{path}: no cached graph")
        torch.cuda.empty_cache()
        reset()
        t_run = time.perf_counter()
        with protocol_route(route), fused_searches() as made:
            r = driver.run_private_search(cfg, None, None, queries[:q],
                                          gnd=gnd[:q])
        run_s = time.perf_counter() - t_run
        if i == 0:
            res["build"] = build_phase_check(
                r.build_stats, cache, run_s, load_int_matrix)
        else:
            check(not r.build_stats, f"{path}: the driver built again")
        groups = math.ceil(q / group)
        check(r.answers.shape == (q, PRIVATE_K)
              and ((r.answers >= -1) & (r.answers < N)).all(),
              f"{path}: answers are not {q}x{PRIVATE_K} ids")
        if non_private or engine == "simple":
            own = own_of["simple"]
        elif engine == "fused":
            own = own_of["fused"]
        else:
            own = own_of["fused route" if route == "fused" else route]
        launches[path] = got = counted(path, own)
        k1 = got["aes_mmo_tables"]
        P = BATCH // 2
        if non_private:
            # the prep of its engine (SimpleBatchPianoPIR: one K1 and one
            # K7c a partition) and nothing in the query loop
            check(k1 == P and got["xor_scan_pallas"] == P,
                  f"{path}: launches {got}: not one prep")
            extra = "no kernel in the query loop"
            preps = 1
        elif engine == "simple":
            # a K1 and a K7c a partition's prep, a K7c a sub-query
            rows = got["xor_scan_pallas"] - k1
            check(k1 % P == 0 and rows > 0, f"{path}: launches {got}")
            preps = k1 // P
            extra = f"{rows} K7c sub-query launches"
        elif engine == "fused":
            check(got["xor_hintgen_pallas"] == k1
                  and got["xor_gather"] == groups * PRIVATE_STEP,
                  f"{path}: launches {got}: not one K7b a prep and one K2 "
                  f"a batch ({groups * PRIVATE_STEP})")
            preps = k1
            extra = f"{groups * PRIVATE_STEP} batches"
        else:
            rounds = got["claim_select"] + got["select_full"]
            check(got["xor_gather"] == k1 + rounds,
                  f"{path}: launches {got}: K2 is not one a prep and one "
                  "a round")
            preps = k1
            extra = f"{rounds} rounds"
            if engine == "device-fused":
                check(len(made) == 1, f"{path}: {len(made)} searches made")
                fs = made[0]
                check(rounds == (groups + 1) * PRIVATE_STEP,
                      f"{path}: {rounds} rounds, not one a step of "
                      f"{groups + 1} searches")
                succ, bound = fused_fetch_check(fs, group, groups + 1, path)
                extra += (f", fetch success {succ:.4f} (bound {bound:.4f}), "
                          f"{fs.refreshes} refreshes in the search")
        if not non_private and engine != "device-fused":
            check(r.success_rate > 0.7, f"{path}: success "
                  f"{r.success_rate:.4f} is not above 0.7")
            extra += f", success {r.success_rate:.4f}"
        extra += (f", {preps - 1} refreshes after the first prep, recall@10 "
                  f"{r.recall:.4f}, {run_s:.2f} s in all")
        res[label] = private_run_line(label, cfg, r, got, extra)
        res[label].update(recall=r.recall, run_s=run_s)
        if profiled:
            traces = list(prof_dir.glob("*.json"))
            check(len(traces) == 1, f"{path}: {len(traces)} traces")
            dev_s, names = trace_device(traces[0])
            check(any(K2_ROW_KERNEL in nm for nm in names),
                  f"{path}: the trace names no K2 launch")
            busy = dev_s / q / res["fused"]["avg_compute_s_per_q"]
            res[label].update(device_s_per_q=dev_s / q, busy=busy)
            print(f"{path}: device time {dev_s / q * 1e3:.3f} ms a query "
                  f"({len(names)} kernels in the trace), busy {busy:.5f} of "
                  f"the unprofiled \"fused\" run's compute time a query")
        del r, made
    torch.cuda.empty_cache()

    # 3. recall on the built graph: private against non-private, the
    # plaintext engine against a random graph, the cluster baseline
    base = res["non_private"]["recall"]
    for label in ("device-fused", "fused concurrent"):
        check(res[label]["recall"] >= base - PRIVATE_RECALL_GAP,
              f"recall {label}: {res[label]['recall']:.4f} is more than "
              f"{PRIVATE_RECALL_GAP} below non-private's {base:.4f}")
    print(f"private recall@10 on the built graph (100 queries): "
          f"non-private {base:.4f}, device-fused "
          f"{res['device-fused']['recall']:.4f}, fused concurrent "
          f"{res['fused concurrent']['recall']:.4f}")
    graph = load_int_matrix(str(cache), N, M)
    tmp.cleanup()
    gnd = None
    for path in ("built graph", "cluster"):
        print(f"-- path {path}")
        torch.cuda.empty_cache()
        reset()
        if gnd is None:
            res[path], gnd = built_graph_phase(vt, queries, graph, seed)
        else:
            res[path] = cluster_phase(vt, queries, gnd, seed)
        launches[path] = counted(path, ("l2_distance",))
        want = res[path]["k6_launches"]
        check(launches[path]["l2_distance"] == want, f"{path}: K6 launches "
              f"{launches[path]['l2_distance']}, not {want}")
    del graph, vt
    torch.cuda.empty_cache()
    path = "latent 12"
    print(f"-- path {path}")
    reset()
    res[path] = hard_latent_phase(seed + 5)
    launches[path] = counted(path, ("l2_distance",))
    want = res[path]["k6_launches"]
    check(launches[path]["l2_distance"] == want, f"{path}: K6 launches "
          f"{launches[path]['l2_distance']}, not {want}")
    torch.cuda.empty_cache()

    # 4. the CLI once
    cli_dir = out_dir / "private_cli"
    shutil.rmtree(cli_dir, ignore_errors=True)
    cli_dir.mkdir(parents=True)
    np.save(cli_dir / "vectors.npy", small_v)
    save_int_matrix(str(cli_dir / "graph.npy"), small_g)
    argv = ["-n", str(PRIVATE_SMALL_N), "-d", str(DIM), "-m", str(M),
            "-q", "10", "-input", str(cli_dir / "vectors.npy"),
            "-graph", str(cli_dir / "graph.npy"),
            "-report", str(cli_dir / "report.txt"),
            "-profile", str(cli_dir / "profile"), "-seed", str(seed)]
    check(cli.main(argv) == 0, "cli.private_search.main failed")
    fields = {}
    for ln in (cli_dir / "report.txt").read_text().splitlines():
        if ln.startswith("** "):
            name, value = ln[3:].rsplit(": ", 1)
            fields[name] = float(value)
    want = [ln[3:].rsplit(": ", 1)[0] for ln in PrivateSearchReport(
        *([0] * 13)).render().splitlines() if ln.startswith("** ")]
    check(sorted(fields) == sorted(want),
          f"CLI report fields {sorted(fields)} are not {sorted(want)}")
    traces = list((cli_dir / "profile").glob("*.json"))
    check(len(traces) == 1, f"CLI: {len(traces)} profile traces")
    dev_s, names = trace_device(traces[0])
    check(any(K2_ROW_KERNEL in nm for nm in names),
          "CLI: the profile trace names no K2 launch")
    (cli_dir / "vectors.npy").unlink()
    (cli_dir / "graph.npy").unlink()
    res["cli"] = dict(fields=fields, device_s=dev_s, kernels=len(names))
    print(f"private CLI n={PRIVATE_SMALL_N}: report with all {len(fields)} "
          f"fields, trace with {len(names)} kernels (K2 among them), "
          f"device time {dev_s * 1e3:.3f} ms")
    res["seconds"] = time.perf_counter() - t_phase
    print(f"private search phase: {res['seconds']:.1f} s")
    return res, launches


# the multi-device phase: the sharded engines as logical shards on one card
# at the canonical deployment (P = 16, S = 124)
MD_SHARDS = 4
MD_PATHS = (("xla", False, False), ("pallas", False, False),
            ("fused", False, False), ("xla", True, False),
            ("xla", False, True))           # (route, table-free, chunk)
MD_EXACT_N = 100_003                  # exact_search -shards 4: n % 4 != 0
# the SIFT100M deployment's per-chip shard (run-private-search.sh's
# commented block, reports/sift100m_plan.json: 8 chips x 2 partitions):
# 12.5M entries of 640 B, batch 4 (P = 2), the probe's per-step shapes
SHARD_N, SHARD_BATCH = 12_500_000, 4
SHARD_BATCHES, SHARD_IDS = 20, 16      # quota 8 a partition
SHARD_STEPS, SHARD_PARALLEL, SHARD_QUERIES, SHARD_STARTS = 32, 4, 4, 64
SHARD_ROUTE = "fused"
SHARD_PREPS = 3                        # timed preps an engine, after a warm
SHARD_PARAMS = dict(C=8192, S=764, Hp=57_344, R=160, T=179_584, k=2,
                    max_q=39_120)
# the shard's rows, a hash of (id, column) (scripts/probe_100m_shard.py's
# host_vec / host_nbrs): 128 f32 in [0, 1) || 32 neighbour ids below n
MIX_A, MIX_B, M32 = 2654435761, 0x9E3779B9, 0xFFFFFFFF


def path_kernels(route: str, table_free: bool, chunk: bool = False) -> tuple:
    """The kernels an engine path launches; it launches no other. The
    chunk-sharded engine (chunk) evaluates its offset columns with K5."""
    own = ("aes_mmo_points" if chunk else "aes_mmo_tables", "xor_gather")
    if route == "pallas":
        own += ("claim_select",)
    if table_free:
        own += ("aes_mmo_points",)         # "fused" takes the fixpoint
    elif route == "fused":
        own += ("select_full",)
    return own


def launch_counts(counters) -> collections.Counter:
    return collections.Counter({k: fn.launches
                                for k, fn in counters.items()})


def state_copy(e) -> dict:
    return {k: v.clone() for k, v in e.state.items()}


def states_equal(a: dict, b: dict, label: str):
    import torch

    check(set(a) == set(b), f"{label}: state keys differ")
    for key in a:
        check(torch.equal(a[key], b[key]), f"{label}: state {key} differs")


def md_drive(e, seed: int, starts) -> dict:
    """One engine through the multi-device path: a warm and a timed prep
    (the same seed), three
    batch-96 batches, fused groups 1 and 16 (20 steps, parallel 3), with
    the state after each stage, the answers and the times."""
    import torch

    from pacmann_tpu_torch.private.fused_search import FusedPrivateSearch

    rec = {}
    e.preprocessing(rng=np.random.default_rng(seed))          # warm
    t0 = time.perf_counter()
    e.preprocessing(rng=np.random.default_rng(seed))
    rec["prep_s"] = time.perf_counter() - t0
    rec["state prep"] = state_copy(e)
    rng = np.random.default_rng(seed + 1)
    e._rng = np.random.default_rng(seed + 2)
    rec["batches"], lat = [], []
    for _ in range(3):
        ids = [int(i) for i in rng.integers(0, N, 96)]
        t0 = time.perf_counter()
        rec["batches"].append((ids, e.query(ids)))
        lat.append(time.perf_counter() - t0)
    rec["batch96_ms"] = [t * 1e3 for t in lat]
    rec["state batches"] = state_copy(e)
    sids, svecs, snbrs = starts
    fs = FusedPrivateSearch(e, sids, svecs, snbrs, dim=DIM, m=M, n=N)
    fs.generator.manual_seed(seed + 3)
    frng = np.random.default_rng(seed + 4)
    for G in (1, 16):
        q = frng.random((G, DIM), dtype=np.float32)
        t0 = time.perf_counter()
        rec[f"fused {G}"] = fs.search(q, k=10, max_step=20, parallel=3)
        rec[f"fused {G} ms/query"] = (time.perf_counter() - t0) * 1e3 / G
        check(((rec[f"fused {G}"] >= 0) & (rec[f"fused {G}"] < N)).all(),
              f"fused group {G}: answers are not valid ids")
    rec["fetch_stats"] = fs.fetch_stats.copy()
    rec["refreshes"] = fs.refreshes
    rec["state fused"] = state_copy(e)
    torch.cuda.synchronize()
    return rec


def multi_device_phase(raw: np.ndarray, db, seed: int, reset, read_counts,
                       counters) -> tuple[dict, dict]:
    """The multi-device tier on one card, MD_SHARDS logical shards
    (make_mesh(devices=["cuda:0"] * 4)) at the canonical deployment: each
    of MD_PATHS on the sharded engine (ShardedPianoEngine, or
    ChunkShardedPianoEngine with S_loc = 31) against DevicePianoEngine on
    the same seeds: bit-equal state after prep, after three batch-96
    batches and after fused groups 1 and 16, the same answers and fetch
    counters, every answered row its raw row (success at least 0.98); the
    sharded path's launches counted from zero and exactly MD_SHARDS times
    the single engine's (per shard one launch of its each; the chunk
    engine's K5 per K1 of the single engine, its select once). Then
    sharded_l2_topk at L2_Q x L2_N x 128 against knn_search and
    cli.exact_search -shards 4 at an n not divisible by 4 (K6 launches
    exact), and dryrun_multichip(8) on eight logical shards."""
    import torch

    from pacmann_tpu_torch.cli import exact_search
    from pacmann_tpu_torch.graph.recall import knn_search
    from pacmann_tpu_torch.parallel.dryrun import dryrun_multichip
    from pacmann_tpu_torch.parallel.sharding import (
        make_mesh, replicate, shard_rows, sharded_l2_topk)
    from pacmann_tpu_torch.pir.device_engine import DevicePianoEngine
    from pacmann_tpu_torch.pir.sharded_engine import (
        ChunkShardedPianoEngine, ShardedPianoEngine)

    t_phase = time.perf_counter()
    mesh = make_mesh(devices=["cuda:0"] * MD_SHARDS)
    where = mesh.describe()
    print(f"-- multi-device: {where}")
    sids = np.random.default_rng(seed).choice(N, 1000, replace=False)
    srows = raw[sids]
    starts = (sids, np.ascontiguousarray(srows[:, :DIM]).view("<f4"),
              srows[:, DIM:DIM + M].astype(np.int64) % N)
    out, launches = {}, {}
    for route, tf, chunk in MD_PATHS:
        path = (f"multi-device {'chunk ' if chunk else ''}{route}"
                + (" table-free" if tf else ""))
        reset()
        t0 = time.perf_counter()
        if chunk:
            sh = ChunkShardedPianoEngine(N, ENTRY_BYTES, BATCH, raw, FAIL,
                                         mesh, kernel_route=route)
        else:
            sh = ShardedPianoEngine(N, ENTRY_BYTES, BATCH, raw, FAIL, mesh,
                                    kernel_route=route, table_free=tf)
        pack_s = time.perf_counter() - t0
        got = md_drive(sh, seed + 10, starts)
        launches[path] = read_counts(path, path_kernels(route, tf, chunk))
        single = DevicePianoEngine(N, ENTRY_BYTES, BATCH, None, FAIL,
                                   packed_db=db, kernel_route=route,
                                   table_free=tf)
        before = launch_counts(counters)
        want = md_drive(single, seed + 10, starts)
        one = launch_counts(counters) - before
        del single
        for stage in ("state prep", "state batches", "state fused"):
            states_equal(got[stage], want[stage], f"{path} {stage}")
        exact = total = 0
        for (ids, a), (_, b) in zip(got["batches"], want["batches"]):
            check(np.array_equal(a, b), f"{path}: answers differ")
            ok = (a == raw[ids]).all(axis=1)
            check((ok | ~a.any(axis=1)).all(), f"{path}: a row answered "
                  "wrongly")
            exact += int(ok.sum())
            total += len(ids)
        check(exact / total >= 0.98, f"{path}: success {exact / total:.4f}")
        for G in (1, 16):
            check(np.array_equal(got[f"fused {G}"], want[f"fused {G}"]),
                  f"{path}: fused group {G} answers differ")
        check(np.array_equal(got["fetch_stats"], want["fetch_stats"])
              and got["refreshes"] == want["refreshes"],
              f"{path}: fetch counters differ")
        # per shard one launch of each of the single engine's; the chunk
        # engine evaluates its columns with K5 where the single engine
        # builds the table with K1, and selects once
        expect = collections.Counter({k: MD_SHARDS * v
                                      for k, v in one.items()})
        if chunk:
            expect["aes_mmo_points"] = expect.pop("aes_mmo_tables", 0)
            for k in ("claim_select", "select_full"):
                expect[k] = one[k]
        expect = {k: expect.get(k, 0) for k in KERNELS}
        check(launches[path] == expect,
              f"{path}: launches {launches[path]} != {expect} "
              f"({MD_SHARDS} shards, single {dict(one)})")
        del sh
        torch.cuda.empty_cache()
        out[path] = dict(
            pack_s=pack_s, prep_s=got["prep_s"],
            single_prep_s=want["prep_s"], batch96_ms=got["batch96_ms"],
            single_batch96_ms=want["batch96_ms"], success=exact / total,
            single_launches=dict(one),
            **{f"fused {G} ms/query": got[f"fused {G} ms/query"]
               for G in (1, 16)},
            **{f"single fused {G} ms/query": want[f"fused {G} ms/query"]
               for G in (1, 16)})
        print(f"{path} ({where}): pack {pack_s:.3f} s; prep s "
              f"{got['prep_s']:.4f} (single {want['prep_s']:.4f}); "
              f"batch-96 ms median {np.median(got['batch96_ms']):.3f} "
              f"(single {np.median(want['batch96_ms']):.3f}); fused ms/query"
              f" group 1 {got['fused 1 ms/query']:.3f} (single "
              f"{want['fused 1 ms/query']:.3f}), group 16 "
              f"{got['fused 16 ms/query']:.3f} (single "
              f"{want['fused 16 ms/query']:.3f}); success "
              f"{exact / total:.4f}; state, answers and fetch counters "
              "equal the single engine's")

    # the row-sharded exact search
    path = "multi-device l2"
    rng = np.random.default_rng(seed + 20)
    vt = torch.as_tensor(int_vectors(rng, L2_N), dtype=torch.float32,
                         device="cuda")
    qt = torch.as_tensor(int_vectors(rng, L2_Q), dtype=torch.float32,
                         device="cuda")
    shards = shard_rows(mesh, vt)
    q_rep = replicate(mesh, qt)
    reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ids, dists = sharded_l2_topk(mesh, q_rep, shards, 10)
    torch.cuda.synchronize()
    topk_ms = (time.perf_counter() - t0) * 1e3
    exact_search.main(["-n", str(MD_EXACT_N), "-q", "100", "-k", "10",
                       "-shards", str(MD_SHARDS)],
                      devices=["cuda:0"] * MD_SHARDS)
    launches[path] = read_counts(path, ("l2_distance",))
    check(launches[path]["l2_distance"] == 3 * MD_SHARDS,
          f"{path}: {launches[path]['l2_distance']} K6 launches, not one a "
          f"shard for the top-k and for each of the CLI's two scans")
    want_d, want_i = knn_search(vt, qt, 10)
    check(torch.equal(ids, want_i) and torch.equal(dists, want_d),
          f"{path}: sharded top-k differs from knn_search")
    print(f"{path} ({where}): sharded_l2_topk {L2_Q} x {L2_N} x {DIM} in "
          f"{topk_ms:.3f} ms, ids and distances equal knn_search's")
    out[path] = dict(topk_ms=topk_ms)
    del vt, qt, shards, q_rep
    torch.cuda.empty_cache()

    path = "multi-device dryrun"
    reset()
    t0 = time.perf_counter()
    dryrun_multichip(8, devices=["cuda:0"] * 8)
    # its engines take the card's default route, "fused" (K3)
    launches[path] = read_counts(path, ("aes_mmo_tables", "aes_mmo_points",
                                        "xor_gather", "select_full",
                                        "l2_distance"))
    out[path] = dict(seconds=time.perf_counter() - t0)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"{path} (8 shards on 1 device(s)): passed in "
          f"{out[path]['seconds']:.2f} s; multi-device phase "
          f"{out['seconds']:.1f} s")
    return out, launches


def mul32(a, c: int):
    """Low 32 bits of a * c for int64 tensors a in [0, 2^32) and c < 2^32,
    without int64 overflow."""
    return (a * (c & 0xFFFF) + (((a * (c >> 16)) & 0xFFFF) << 16)) & M32


def shard_entries(gidx, n: int):
    """(len(gidx), 160) int32 rows of entries gidx (int64 CUDA tensor):
    the probe's formula, hashed on the card."""
    import torch

    g = gidx.long()[:, None]
    w = torch.arange(DIM, device=g.device)
    h = (mul32((g * DIM + w) & M32, MIX_A) + MIX_B) & M32
    vec = (h >> 8).to(torch.float32) * 2.0 ** -24
    j = torch.arange(M, device=g.device)
    h2 = mul32(g ^ ((j * MIX_B) & M32), MIX_A)
    h2 ^= h2 >> 15
    return torch.cat([vec.view(torch.int32), (h2 % n).to(torch.int32)], 1)


def state_bytes(states) -> dict:
    out = collections.Counter()
    for st in states:
        for k, v in st.items():
            out[k] += v.numel() * v.element_size()
    return dict(out)


def sift100m_shard_phase(seed: int, reset, read_counts,
                         counters) -> tuple[dict, dict]:
    """The SIFT100M deployment's per-chip shard at full size: 12.5M rows
    of 640 B made on the card from a hash of (id, column) (the host never
    holds them), a 2-shard ShardedPianoEngine (one partition a shard) and
    the single DevicePianoEngine on route SHARD_ROUTE from the same seeds.
    Prep both (a warm and SHARD_PREPS timed preps from one seed; state
    equal shard by shard), SHARD_BATCHES batches of
    SHARD_IDS ids (quota 8; every served entry equals its formula, success
    at least 0.98; answers and state equal), then the fused search over
    each engine on SHARD_QUERIES queries (group 1, 32 steps, parallel 4,
    m = 32: quota 64; the same answers and fetch counters, success within
    0.03 of the model, answers ranked by their formula distances). Launches
    counted from zero over both engines: the sharded engine's exactly twice
    the single's. K3 and K4 against their plain versions at the shard's
    quotas, K1 at its prep lattice and K2 at its prep gather. Prints prep s, batch ms, fused ms/query with the maintenance
    split, resident state per engine and the peak device memory."""
    import torch

    from pacmann_tpu_torch.ops import aes, xor_scan
    from pacmann_tpu_torch.parallel.sharding import make_mesh
    from pacmann_tpu_torch.pir.device_engine import (
        DevicePianoEngine, _build_skip)
    from pacmann_tpu_torch.pir.params import expected_success_rate
    from pacmann_tpu_torch.pir.sharded_engine import ShardedPianoEngine
    from pacmann_tpu_torch.private.fused_search import FusedPrivateSearch

    t_phase = time.perf_counter()
    n = SHARD_N
    print(f"-- SIFT100M shard: n={n}, {ENTRY_BYTES} B entries, batch "
          f"{SHARD_BATCH}, route {SHARD_ROUTE}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    raw = torch.empty((n, ENTRY_BYTES // 4), dtype=torch.int32,
                      device="cuda")
    for lo in range(0, n, 1 << 20):
        hi = min(n, lo + (1 << 20))
        raw[lo:hi] = shard_entries(
            torch.arange(lo, hi, device="cuda"), n)
    vec = raw[:, :DIM].view(torch.float32)
    nbr = raw[:, DIM:DIM + M]
    check(bool(torch.isfinite(vec).all()) and bool((nbr >= 0).all())
          and bool((nbr < n).all()), "the shard's rows are not a valid "
          "vertex DB")
    del vec, nbr
    torch.cuda.synchronize()
    synth_s = time.perf_counter() - t0
    mesh = make_mesh(devices=["cuda:0"] * 2)
    t0 = time.perf_counter()
    sh = ShardedPianoEngine(n, ENTRY_BYTES, SHARD_BATCH, raw, FAIL, mesh,
                            kernel_route=SHARD_ROUTE)
    torch.cuda.synchronize()
    pack_sh = time.perf_counter() - t0
    t0 = time.perf_counter()
    single = DevicePianoEngine(n, ENTRY_BYTES, SHARD_BATCH, raw, FAIL,
                               device="cuda", kernel_route=SHARD_ROUTE)
    torch.cuda.synchronize()
    pack_single = time.perf_counter() - t0
    del raw
    torch.cuda.empty_cache()
    p, c = single.params, single.config
    P = c.partition_num
    got_params = dict(C=p.chunk_size, S=p.set_size, Hp=p.primary_hint_num,
                      R=p.max_query_per_chunk,
                      T=p.primary_hint_num + p.set_size
                      * p.max_query_per_chunk, k=single.k,
                      max_q=p.max_query_num)
    check(got_params == SHARD_PARAMS and P == 2,
          f"shard parameters {got_params}, P={P}")
    print(f"shard rows on the card in {synth_s:.2f} s; pack: sharded "
          f"{pack_sh:.2f} s ({mesh.describe()}), single {pack_single:.2f} s;"
          f" P={P}, {got_params}; db {single.db.numel() * 4 / 1e9:.3f} GB "
          f"({single.db.numel()} int32 elements)")

    def ranges():
        return zip(sh.shard_states, sh.partition_ranges)

    def equal_by_shard(label):
        for st, (lo, hi) in ranges():
            for key, v in st.items():
                check(torch.equal(v, single.state[key][lo:hi]),
                      f"shard {label}: state {key} of partitions "
                      f"[{lo}, {hi}) differs")

    engines = {"sharded": sh, "single": single}
    deltas = {k: collections.Counter() for k in engines}

    def counted(name, fn):
        before = launch_counts(counters)
        res = fn()
        deltas[name] += launch_counts(counters) - before
        return res

    path = "SIFT100M shard"
    reset()
    prep_s = {}
    for name, e in engines.items():
        times = []
        for _ in range(1 + SHARD_PREPS):         # a warm prep, then timed
            t0 = time.perf_counter()
            counted(name, lambda: e.preprocessing(
                rng=np.random.default_rng(seed + 1)))
            times.append(time.perf_counter() - t0)
        prep_s[name] = min(times[1:])
        print(f"shard prep {name} s: "
              + ", ".join(f"{t:.4f}" for t in times[1:])
              + f" (min {prep_s[name]:.4f}; warm {times[0]:.4f})")
    equal_by_shard("after prep")
    rng = np.random.default_rng(seed + 2)
    for e in engines.values():
        e._rng = np.random.default_rng(seed + 3)
    batch_ms = {k: [] for k in engines}
    exact = total = 0
    for _ in range(SHARD_BATCHES):
        ids = [int(i) for i in rng.integers(0, n, SHARD_IDS)]
        outs = {}
        for name, e in engines.items():
            t0 = time.perf_counter()
            outs[name] = counted(name, lambda: e.query(ids))
            batch_ms[name].append((time.perf_counter() - t0) * 1e3)
        check(np.array_equal(outs["sharded"], outs["single"]),
              "shard batch: answers differ")
        want = shard_entries(torch.tensor(ids, device="cuda"),
                             n).cpu().numpy().view(np.uint32)
        a = outs["sharded"]
        ok = (a == want).all(axis=1)
        check((ok | ~a.any(axis=1)).all(), "shard batch: an entry differs "
              "from its formula")
        exact += int(ok.sum())
        total += len(ids)
    success = exact / total
    check(success >= 0.98, f"shard batch success {success:.4f} < 0.98")
    equal_by_shard("after the batches")

    sids = (np.arange(SHARD_STARTS, dtype=np.uint64) * MIX_A) % n
    srows = shard_entries(torch.as_tensor(sids.astype(np.int64),
                                          device="cuda"), n).cpu().numpy()
    qs = np.random.default_rng(seed + 4).random(
        (SHARD_QUERIES, DIM)).astype(np.float32)
    quota = SHARD_PARALLEL * M // P
    searches = {}
    for name, e in engines.items():
        fs = FusedPrivateSearch(e, sids.astype(np.int64),
                                np.ascontiguousarray(srows[:, :DIM])
                                .view(np.float32), srows[:, DIM:], dim=DIM,
                                m=M, n=n)
        fs.generator.manual_seed(seed + 5)
        ans, ms = [], []
        for i in range(SHARD_QUERIES):
            t0 = time.perf_counter()
            ans.append(counted(name, lambda: fs.search(
                qs[i:i + 1], k=10, max_step=SHARD_STEPS,
                parallel=SHARD_PARALLEL)))
            ms.append((time.perf_counter() - t0) * 1e3)
        searches[name] = dict(fs=fs, ans=np.concatenate(ans), ms=ms)
    a, b = searches["sharded"], searches["single"]
    check(np.array_equal(a["ans"], b["ans"]), "shard fused: answers differ")
    check(np.array_equal(a["fs"].fetch_stats, b["fs"].fetch_stats)
          and a["fs"].refreshes == b["fs"].refreshes == 0,
          "shard fused: fetch counters or refreshes differ")
    equal_by_shard("after the fused searches")
    launches = {path: read_counts(path, ("aes_mmo_tables", "xor_gather",
                                         "select_full"))}
    expect = {k: 3 * deltas["single"][k] for k in KERNELS}
    check(deltas["sharded"] == collections.Counter(
        {k: 2 * v for k, v in deltas["single"].items()})
          and launches[path] == expect,
          f"shard launches: sharded {dict(deltas['sharded'])}, single "
          f"{dict(deltas['single'])}, total {launches[path]}")
    fstats = a["fs"].fetch_stats
    want_step = int(round(fstats[0] / (SHARD_QUERIES * SHARD_STEPS)))
    bound_rate = expected_success_rate(want_step, P, quota, FAIL)
    fsucc = a["fs"].fetch_success_rate()
    check(abs(fsucc - bound_rate) <= 0.03, f"shard fused: fetch success "
          f"{fsucc:.4f} is not within 0.03 of {bound_rate:.4f}")
    for row, q in zip(a["ans"], qs):
        got_ids = row[row >= 0]
        check(len(got_ids) > 0 and (got_ids < n).all(),
              "shard fused: answers are not valid ids")
        v = shard_entries(torch.as_tensor(got_ids, device="cuda"), n)[
            :, :DIM].view(torch.float32)
        d = ((v - torch.as_tensor(q, device="cuda")) ** 2).sum(1)
        check(bool((d[1:] >= d[:-1] - 1e-4).all()), "shard fused: answers "
              "not ranked by their formula distances")

    windows = p.max_query_num // (quota * SHARD_STEPS)
    per_engine = {}
    for name, e in engines.items():
        db_b = sum(x.numel() * 4 for x in (e.db if isinstance(e.db, list)
                                             else [e.db]))
        st = state_bytes(e.shard_states if name == "sharded"
                         else [e.state])
        per_engine[name] = dict(
            prep_s=prep_s[name], batch_ms=batch_ms[name],
            fused_ms_per_query=searches[name]["ms"],
            maintenance_ms_per_query=prep_s[name] * 1e3 / windows,
            db_bytes=db_b, state_bytes=st,
            resident_gb=(db_b + sum(st.values())) / 1e9)
        print(f"shard {name}: prep {prep_s[name]:.4f} s; batch of "
              f"{SHARD_IDS} ms median {np.median(batch_ms[name]):.3f}, min "
              f"{min(batch_ms[name]):.3f}; fused ms/query median "
              f"{np.median(searches[name]['ms']):.1f} ({SHARD_STEPS} steps, "
              f"parallel {SHARD_PARALLEL}, quota {quota}), maintenance "
              f"{prep_s[name] * 1e3 / windows:.1f} ms/query ({windows} "
              f"queries a window); resident {per_engine[name]['resident_gb']:.3f}"
              f" GB: DB {db_b / 1e9:.3f}, "
              + ", ".join(f"{k} {v / 1e9:.3f}" for k, v in st.items()))
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"shard: batch success {exact}/{total} = {success:.4f}; fused "
          f"fetch success {fsucc:.4f} vs model {bound_rate:.4f}; peak device "
          f"memory {peak:.3f} GB with both engines")
    # the kernels against their plain versions at the shard's shapes: K3
    # and K4 at its quotas, K1 at its prep lattice and K2 at its prep
    # gather (the row form: C = 8,192) on the single engine's DB
    k34 = compare_protocol(single.state["table"], p, P, c.partition_size,
                           (SHARD_IDS // P, quota), seed + 6,
                           kinds=("uniform", "deep"), plain_reps=0)
    del sh, engines, searches
    torch.cuda.empty_cache()
    R, Hp = p.max_query_per_chunk, p.primary_hint_num
    T = Hp + p.set_size * R
    rk = aes.round_keys([np.random.default_rng(seed + 7).bytes(16)
                         for _ in range(P)]).to("cuda")
    k1, table = k1_check(rk, T, p.set_size, p.chunk_mask, "SIFT100M shard",
                         reps=3, plain_reps=1)
    off = torch.where(_build_skip(P, T, Hp, R, p.set_size, "cuda"),
                      xor_scan.SKIP, table).contiguous()
    del table
    k2 = k2_forms(single.db, off, single.k, "SIFT100M shard prep", reps=3,
                  plain_reps=1)
    del single, off
    torch.cuda.empty_cache()
    out = dict(synth_s=synth_s, pack_s=dict(sharded=pack_sh,
                                            single=pack_single),
               params=got_params, batch_success=success,
               fetch_success=fsucc, fetch_bound=bound_rate,
               peak_device_gb=peak, engines=per_engine, k3_k4=k34, k1=k1,
               k2=k2, seconds=time.perf_counter() - t_phase)
    print(f"SIFT100M shard phase {out['seconds']:.1f} s")
    return out, launches


# the scale phase: e2e_scale's canonical 1M demo on the continuum data of
# SCALE_LATENT latent dimensions synthesized on the card, with the recipe
# of reports/e2e_1000000_continuum_l12dev_k16c16x2x3_report.json; the
# baselines on the host-synth continuum data; plan_100m over the card
# repeated 8 times. Its reports and logs go under chiprun_out/.
SCALE_N, SCALE_LATENT = 1_000_000, 12
SCALE_E2E_ARGS = ("--n", str(SCALE_N), "--rounds", "9", "--queries", "100",
                  "--continuum", "--device-synth", "--latent",
                  str(SCALE_LATENT), "--keep", "16", "--corridor", "16:2:3",
                  "--k", "10", "--step", "20", "--parallel", "3",
                  "--rebuild")
SCALE_BASE_ARGS = ("--n", str(SCALE_N), "--latent", str(SCALE_LATENT),
                   "--continuum", "--queries", "100", "--k", "10")
SCALE_PRIVATE_GAP = 0.03       # private recall within this of plaintext
# native_lib against the plain versions on the card's host: the 1M prep's
# tables (P, T, S), and K7c's ragged flat scan (B, S, C) at k = 2
NATIVE_TABLE = (16, 12_512, 124)
NATIVE_SCAN = (9_001, 301, 1_000)


def host_cpu() -> str:
    from pacmann_tpu_torch.scripts import cpu_model

    return f"{cpu_model()}, {os.cpu_count()} logical CPUs"


def native_phase(seed: int) -> dict:
    """native_lib against the plain torch versions on the card's host, on
    CPU tensors: the 1M prep's PRF tables (aes.prf_tables_native against
    aes.prf_tables_plain) and K7c's ragged scan (xor_scan.xor_scan_native
    against attic.xor_scan_pallas_plain), bit-equal; each timed once on
    the host clock beside the host CPU's model."""
    import torch

    from pacmann_tpu_torch import native_lib
    from pacmann_tpu_torch.ops import aes, attic, xor_scan

    check(native_lib.available(), "native_lib did not build or load on "
          "the card's host")
    rng = np.random.default_rng(seed)
    P, T, S = NATIVE_TABLE
    mask = 511
    rk = aes.round_keys([rng.bytes(16) for _ in range(P)])
    t0 = time.perf_counter()
    native = aes.prf_tables_native(rk, T, S, mask)
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    plain = aes.prf_tables_plain(rk, T, S, mask)
    plain_s = time.perf_counter() - t0
    err = max_abs_err(native, plain)
    check(err == 0, f"native PRF tables differ from the plain version "
          f"({err})")
    res = {"cpu": host_cpu(), "tables": dict(
        shape=NATIVE_TABLE, max_abs_err=err, native_ms=native_s * 1e3,
        plain_ms=plain_s * 1e3)}
    B, S, C = NATIVE_SCAN
    k = 2
    db = torch.from_numpy(rng.integers(0, 2**32, size=(S, C * k, 128),
                                       dtype=np.uint32).view(np.int32))
    off = torch.from_numpy(rng.integers(0, C, size=(B, S)).astype(np.int32))
    skip = torch.from_numpy(rng.random((B, S)) < 0.25)
    t0 = time.perf_counter()
    native = xor_scan.xor_scan_native(db, off, skip, k)
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    plain = attic.xor_scan_pallas_plain(db, off, skip, k)
    plain_s = time.perf_counter() - t0
    err = max_abs_err(native, plain)
    check(err == 0, f"native XOR scan differs from the plain version "
          f"({err})")
    res["scan"] = dict(shape=NATIVE_SCAN, k=k, max_abs_err=err,
                       native_ms=native_s * 1e3, plain_ms=plain_s * 1e3)
    for name in ("tables", "scan"):
        r = res[name]
        print(f"native_lib {name} {r['shape']}: bit-equal to the plain "
              f"version; host {r['native_ms']:.1f} ms (native) / "
              f"{r['plain_ms']:.1f} ms (plain) on {res['cpu']}")
    return res


def scale_phase(seed: int, reset, read_counts) -> tuple[dict, dict]:
    """The port's scale scripts on the card, each a counted path (its own
    launches from zero): e2e_scale at SCALE_N (build s, plaintext and
    private recall, the latter within SCALE_PRIVATE_GAP, prep s, private
    ms/query, peak GiB; no native_lib call on this CUDA path),
    baselines_scale (exact recall 1.0, the cluster's recall, k-means s,
    ms/query each), plan_100m (the SIFT100M plan fits the card, the mini
    8-shard run at least 30/32 exact); then native_phase. Each script's
    own output goes to chiprun_out/scale_<name>.log, its reports to
    chiprun_out/reports/torch/."""
    from pacmann_tpu_torch import native_lib
    from pacmann_tpu_torch.scripts import baselines_scale, e2e_scale, plan_100m

    out = Path("chiprun_out")
    reports = out / "reports" / "torch"
    reports.mkdir(parents=True, exist_ok=True)
    launches, res = {}, {}

    def run(label, script, argv, own):
        print(f"-- path {label}")
        native_lib.reset_calls()
        reset()
        t0 = time.perf_counter()
        with open(out / f"scale_{script.__name__.rsplit('.', 1)[1]}.log",
                  "w") as log, contextlib.redirect_stdout(log):
            got = script.main([*argv, "--out", str(reports)])
        wall = time.perf_counter() - t0
        launches[label] = read_counts(label, own)
        used = {fn.__name__: fn.calls for fn in native_lib.ENTRY_POINTS
                if fn.calls}
        check(not used, f"path {label} called native_lib on the card: "
              f"{used}")
        return got, wall

    rep, wall = run("e2e 1M", e2e_scale, SCALE_E2E_ARGS,
                    ("aes_mmo_tables", "xor_gather", "l2_distance"))
    print(f"e2e_scale n={rep['n']} continuum l{rep['latent']} dev, rounds "
          f"{rep['rounds']}, corridor {rep['corridor']} ({rep['gpu']}): "
          f"build {rep['build_s']} s, "
          f"plaintext recall@10 {rep['plaintext_recall']}, private "
          f"{rep['private_recall']}, prep {rep['prep_s']} s, private "
          f"{rep['private_ms_per_query']} ms/query, peak "
          f"{rep['peak_gib']} GiB (build {rep['peak_build_gib']} GiB); "
          f"{wall:.1f} s")
    check(rep["private_recall"] >= rep["plaintext_recall"]
          - SCALE_PRIVATE_GAP, f"e2e private recall {rep['private_recall']} "
          f"more than {SCALE_PRIVATE_GAP} below plaintext "
          f"{rep['plaintext_recall']}")
    res["e2e"] = dict(rep, wall_s=wall)

    base, wall = run("baselines 1M", baselines_scale, SCALE_BASE_ARGS,
                     ("l2_distance",))
    print(f"baselines_scale n={SCALE_N} continuum l{SCALE_LATENT} "
          f"({base['device']}): exact recall@10 {base['exact_recall']:.4f}, "
          f"{base['exact_ms_per_query']:.4f} ms/query; cluster recall@10 "
          f"{base['cluster_recall']:.4f}, k-means {base['kmeans_s']:.2f} s, "
          f"{base['cluster_ms_per_query']:.4f} ms/query; {wall:.1f} s")
    check(base["exact_recall"] == 1.0, "exact baseline recall is not 1.0")
    res["baselines"] = dict(base, wall_s=wall)

    plan, wall = run("plan 100M", plan_100m, (),
                     ("aes_mmo_tables", "xor_gather"))
    mini = plan["mini_run"]
    print(f"plan_100m: {plan['per_card_total_gib']} GiB a card of "
          f"{plan['card_memory_gib']} GiB ({plan['card']}), fits "
          f"{plan['fits']}; mini run {mini['exact']}/{mini['total']} exact "
          f"({mini['mesh']}); {wall:.1f} s")
    check(plan["fits"], "the SIFT100M plan does not fit the card")
    check(mini["exact"] >= mini["total"] - 2, "plan_100m's mini run: "
          f"{mini['exact']}/{mini['total']} exact")
    res["plan_100m"] = dict(plan, wall_s=wall)
    res["native"] = native_phase(seed)
    return res, launches


def fused_step_syncs(db, raw: np.ndarray, seed: int) -> dict:
    """The host syncs of one device-only group-1 search
    (bench.device_steps: bench's 20 steps, parallel 3) on the main
    deployment's DB, counted under torch.cuda.set_sync_debug_mode("warn"),
    each with the port's frames that led to it (innermost first). A
    control sync (.item()) first shows that the mode reports syncs."""
    import traceback
    import warnings

    import torch

    from pacmann_tpu_torch import bench
    from pacmann_tpu_torch.pir.device_engine import DevicePianoEngine
    from pacmann_tpu_torch.private.fused_search import FusedPrivateSearch

    e = DevicePianoEngine(N, ENTRY_BYTES, BATCH, None, FAIL, packed_db=db)
    e.preprocessing(rng=np.random.default_rng(seed))
    rng = np.random.default_rng(seed + 1)
    sids = rng.choice(N, 1000, replace=False)
    srows = raw[sids]
    fs = FusedPrivateSearch(
        e, sids, np.ascontiguousarray(srows[:, :DIM]).view("<f4"),
        srows[:, DIM:DIM + M].astype(np.int64) % N, dim=DIM, m=M, n=N)
    q = torch.as_tensor(rng.random((1, DIM), dtype=np.float32),
                        device="cuda")
    fs.generator.manual_seed(seed)
    bench.device_steps(fs, q, bench.STEPS, bench.PARALLEL)      # warm
    torch.cuda.synchronize()
    sites = []

    def record(message, category, filename, lineno, file=None, line=None):
        port = [f"{Path(f.filename).name}:{f.lineno}"
                for f in traceback.extract_stack()[:-1]
                if "pacmann_tpu_torch" in f.filename]
        sites.append(" < ".join(reversed(port))
                     or f"{Path(filename).name}:{lineno}")

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            torch.zeros(1, device="cuda").item()                # control
            control = len(sites)
            bench.device_steps(fs, q, bench.STEPS, bench.PARALLEL)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    check(control >= 1, "set_sync_debug_mode reported no sync for .item()")
    by_site = collections.Counter(sites[control:])
    total = sum(by_site.values())
    print(f"device-only group 1: {total} host syncs in {bench.STEPS} steps "
          f"({total / bench.STEPS:.2f} a step); by site: "
          + "; ".join(f"{n}x {site}" for site, n in by_site.most_common()))
    return dict(syncs=total, per_step=total / bench.STEPS,
                sites=dict(by_site.most_common()))


def bench_phase(db, raw: np.ndarray, seed: int, reset,
                read_counts) -> tuple[dict, dict]:
    """pacmann_tpu_torch.bench's three modes at full size, as `python
    bench_torch.py` runs them on the engine's protocol route, each a path
    of its own: "bench" (1M x 640 B: prep, batch 96, fused groups 1, 16,
    32 and 64, the device-only group 1), "bench big" (3,201,821 x 896 B,
    batch 32) and "bench linear" (100 x 1M x 128 u32 dot products, plain
    torch: no kernel). Each mode's JSON line is printed, then held: batch
    success at least 0.98 (main) or within 0.03 under the FCFS model of a
    batch and its retry round (BIG: quota 2 a round), fetch success within
    0.03 of its bound, distinct prep checksums and one exact row a
    partition after the last prep, valid device-only answers, 32 exact
    sampled products. Then the device-only search's host syncs
    (fused_step_syncs), and K1 and K2 (row form) at the BIG prep shape
    against their plain versions (uncounted)."""
    import torch

    from pacmann_tpu_torch import bench
    from pacmann_tpu_torch.ops import aes
    from pacmann_tpu_torch.pir.device_engine import resolve_route
    from pacmann_tpu_torch.pir.params import (derive_batch_params,
                                              derive_piano_params,
                                              expected_success_rate)

    # the route of the main mode's shape; BIG's (Hp = 7,168, S = 196)
    # resolves to the same
    c = derive_batch_params(N, ENTRY_BYTES, BATCH, FAIL)
    p = derive_piano_params(c.partition_size, ENTRY_BYTES, FAIL)
    route = resolve_route(None, "cuda", Hp=p.primary_hint_num, S=p.set_size)
    engine_kernels = path_kernels(route, False)
    P = BATCH // 2                                  # the partitions
    res, launches = {}, {}
    for path, run, own in (
            ("bench", lambda: bench.hintgen(bench.MAIN_N), engine_kernels),
            ("bench big", bench.big_perf, engine_kernels),
            ("bench linear", bench.linear_scan, ())):
        print(f"-- path {path}")
        torch.cuda.empty_cache()
        reset()
        t0 = time.perf_counter()
        out = run()
        launches[path] = read_counts(path, own)
        print(json.dumps(out))
        res[path] = dict(out, seconds=time.perf_counter() - t0)
        torch.cuda.empty_cache()
        x = out["extra"]
        check(x["platform"] == "gpu", f"{path}: platform {x['platform']}")
        if path != "bench linear":
            check(len(set(x["prep_checksums"])) == bench.PREP_RUNS,
                  f"{path}: prep checksums {x['prep_checksums']}")
            check(x["rows_exact_after_prep"] == f"{P}/{P}",
                  f"{path}: {x['rows_exact_after_prep']} rows exact after "
                  "the last prep")
    x = res["bench"]["extra"]
    check(x["online_success_rate"] >= 0.98,
          f"bench: batch-96 success {x['online_success_rate']} < 0.98")
    for G in (16, 32, 64):
        succ, b = x[f"fused{G}_fetch_success"], x[f"fused{G}_success_bound"]
        check(abs(succ - b) <= 0.03, f"bench: group {G} fetch success "
              f"{succ} is not within 0.03 of its bound {b}")
    check(x["fused_group1_device_ids_valid"],
          "bench: the device-only group 1 answered invalid ids")
    x = res["bench big"]["extra"]
    model = expected_success_rate(bench.BIG_BATCH, P,
                                  2 * (bench.BIG_BATCH // P), FAIL)
    print(f"bench big: batch-32 success {x['batch_success_rate']} against "
          f"the model of a batch and its retry round {model:.4f}")
    check(x["batch_success_rate"] >= model - 0.03,
          f"bench big: batch-32 success {x['batch_success_rate']} < "
          f"{model:.4f} - 0.03")
    res["bench big"]["success_model"] = model
    check(res["bench linear"]["extra"]["sampled_products_exact"]
          == f"{bench.LINEAR_SAMPLES}/{bench.LINEAR_SAMPLES}",
          "bench linear: sampled products differ from numpy's")
    res["syncs"] = fused_step_syncs(db, raw, seed)
    torch.cuda.empty_cache()
    rng = np.random.default_rng(seed + 1)
    rk = aes.round_keys([rng.bytes(16) for _ in range(P)]).cuda()
    res["k2_big"], res["k1_big"] = compare_k2_prep(
        rk, seed + 2, bench.BIG_N, bench.BIG_ENTRY_BYTES, "BIG prep")
    return res, launches


def gpu_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return proc.stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    try:
        from pacmann_tpu_torch.ops import aes, attic, distance, xor_scan
        from pacmann_tpu_torch.ops import protocol_kernels as pk
        from pacmann_tpu_torch.pir.params import (
            derive_batch_params, derive_piano_params)
        from pacmann_tpu_torch.pir.device_engine import (
            DevicePianoEngine, _build_skip)
        from pacmann_tpu_torch.private.fused_search import FusedPrivateSearch
        from pacmann_tpu_torch.utils import cuda_lib
        from pacmann_tpu_torch.bench import synth_raw
    except ImportError as exc:
        print(f"chip_smoke: run from the repository root ({exc})",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = gpu_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")

    # 2. build, one nvcc per source, all started together
    names = ("aes_mmo", "xor_gather", "protocol", "l2_distance",
             "refresh_parity")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(cuda_lib.load, names))
    print(f"build: {time.perf_counter() - t0:.2f} s for {len(names)} "
          "sources in parallel")
    ptxas_notes = {}
    for name in names:
        note = cuda_lib.BUILD / f"{name}.ptxas.txt"
        ptxas_notes[name] = note.read_text() if note.exists() else ""
        lines = [ln.strip() for ln in ptxas_notes[name].splitlines()]
        spills = [ln for ln in lines if "spill" in ln
                  and "0 bytes spill stores, 0 bytes spill loads" not in ln]
        print(f"build {name}: nvcc "
              f"{cuda_lib.build_seconds.get(name, 0.0):.2f} s "
              + " | ".join(ln for ln in lines if "registers" in ln)
              + (f"; spills: {' | '.join(spills)}" if spills else
                 "; no spills"))
        if name in ("aes_mmo", "xor_gather", "protocol", "l2_distance"):
            check(ptxas_notes[name] and not spills,
                  f"ptxas reports spills (or no report) for {name}")

    # the launch counters of every kernel; each counted run sets them to 0
    # just before and reads them just after
    counters = {"aes_mmo_tables": aes.aes_mmo_cuda,
                "xor_gather": xor_scan.xor_gather_cuda,
                "claim_select": pk.claim_select_cuda,
                "select_full": pk.select_full_cuda,
                "aes_mmo_points": aes.aes_mmo_points_cuda,
                "l2_distance": distance.l2_distance_cuda,
                "xor_hintgen_mm_s8p": attic.xor_hintgen_mm_s8p_cuda,
                "xor_hintgen_pallas": attic.xor_hintgen_pallas_cuda,
                "xor_scan_pallas": attic.xor_scan_pallas_cuda,
                "refresh_parity": attic.refresh_parity_cuda}
    check(tuple(counters) == KERNELS, "a kernel has no launch counter")

    def reset_counts():
        for fn in counters.values():
            fn.launches = 0

    def read_counts(path: str, own: tuple) -> dict:
        torch.cuda.synchronize()
        got = {k: fn.launches for k, fn in counters.items()}
        print(f"path {path} launches: {got}")
        for name, count in got.items():
            if name in own:
                check(count > 0, f"kernel {name} was not launched on path "
                      f"{path}")
            else:
                check(count == 0, f"path {path} launched {name}")
        return got

    # the engine's DB (packing runs no kernel)
    raw = synth_raw(N, ENTRY_BYTES // 4, args.seed, DIM, M)
    t0 = time.perf_counter()
    engine = DevicePianoEngine(N, ENTRY_BYTES, BATCH, raw, FAIL,
                               device="cuda")
    torch.cuda.synchronize()
    p, c = engine.params, engine.config
    P, S, Hp, R = (c.partition_num, p.set_size, p.primary_hint_num,
                   p.max_query_per_chunk)
    T = Hp + S * R
    print(f"DB upload+pack {time.perf_counter() - t0:.3f} s: n={N}, "
          f"{ENTRY_BYTES} B entries, P={P}, C={p.chunk_size}, S={S}, "
          f"Hp={Hp}, R={R}, T={T}, k={engine.k}, max_q={p.max_query_num}, "
          f"db {engine.db.numel() * 4 / 1e9:.3f} GB")

    # 3. kernels against their plain versions at the main path's shapes,
    # then the routes against the CPU and against each other
    k1 = compare_k1(args.seed + 10, T, S, p.chunk_mask)
    table, k1_rk = k1.pop("table"), k1.pop("rk")
    # a ragged lattice: S > 256, T * S no multiple of a block, a mask that
    # is no power of two
    k1_ragged = k1_check(k1_rk, K1_RAGGED_T, K1_RAGGED_S, K1_RAGGED_MASK,
                         "ragged", reps=10, plain_reps=1)[0]
    k5 = compare_k5(k1_rk, table, p, (6, 96), args.seed + 15)
    skip = _build_skip(P, T, Hp, R, S, engine.device)
    # the bench shapes and the private driver's (group 8: Q = 48)
    pq = private_quotas(P)
    k2 = compare_k2(engine.db, table, skip, sorted({6, 96, *pq}),
                    args.seed + 11)
    k34 = compare_protocol(table, p, P, c.partition_size,
                           sorted({6, 96, 384, *pq}), args.seed + 13)
    k4_edge = compare_k4_edge(table, p, P, 96, args.seed + 27)
    # the repair pins: K2 at k = 5 and 8; K3/K4 at Hp = 14,336 (n = 7M)
    k2_wide = compare_k2_wide(table, skip, p.chunk_size, args.seed + 19)
    k2_ragged = compare_k2_ragged(args.seed + 23)
    k2_5m, k1_5m = compare_k2_prep(k1_rk, args.seed + 24, BIG_N,
                                   ENTRY_BYTES, "5M prep")
    k2_sliced = compare_k2_sliced(k1_rk, args.seed + 25)
    c7 = derive_batch_params(PROTOCOL_PIN_N, ENTRY_BYTES, BATCH, FAIL)
    p7 = derive_piano_params(c7.partition_size, ENTRY_BYTES, FAIL)
    table7 = aes.aes_mmo_cuda(
        k1_rk, p7.primary_hint_num + p7.set_size * p7.max_query_per_chunk,
        p7.set_size, p7.chunk_mask)
    print(f"K3/K4 pin: n={PROTOCOL_PIN_N}, shared memory a CTA "
          f"{pk.select_smem_bytes(p7.primary_hint_num, p7.set_size)} B "
          f"(opt-in limit {pk.smem_limit(torch.cuda.current_device())} B); "
          f"max_query_num {p7.max_query_num}")
    k34_wide = compare_protocol(table7, p7, c7.partition_num,
                                c7.partition_size, (6, 96), args.seed + 21)
    # the pin's whole budget in one select: max_query_num rounds a partition
    k34_wide.update(compare_protocol(
        table7, p7, c7.partition_num, c7.partition_size,
        (p7.max_query_num,), args.seed + 25, kinds=("uniform",),
        plain_reps=0))
    del table7
    k3_wide = compare_k3_wide(args.seed + 26)
    torch.cuda.empty_cache()
    # the attic at the main deployment's shapes, its entry points counted
    k7, attic_launches = attic_phase(engine.db, table, skip, args.seed + 22,
                                     reset_counts, read_counts)
    del table, skip, k1_rk
    torch.cuda.empty_cache()
    k6 = compare_k6(args.seed + 17)
    torch.cuda.empty_cache()
    for route in ROUTES:
        small_parity(args.seed + 12, route)
    for route in TABLE_FREE_ROUTES:
        small_parity(args.seed + 12, route, table_free=True)
    plaintext_parity(args.seed + 18)
    route_identity(engine.db, raw, args.seed + 14)
    torch.cuda.empty_cache()
    resident = resident_state(engine.db, args.seed + 16)
    torch.cuda.empty_cache()

    # 4. the main path once per route with the table, then table-free on
    # "xla" and "pallas", launch counters from zero for each path

    sids = np.random.default_rng(args.seed + 30).choice(N, 1000,
                                                        replace=False)
    srows = raw[sids]
    paths, launches = {}, {"attic": attic_launches}
    torch.cuda.reset_peak_memory_stats()
    for route, tf in [(r, False) for r in ROUTES] + [
            (r, True) for r in TABLE_FREE_ROUTES]:
        path = route + (" table-free" if tf else "")
        print(f"-- path {path}")
        e = DevicePianoEngine(N, ENTRY_BYTES, BATCH, None, FAIL,
                              packed_db=engine.db, kernel_route=route,
                              table_free=tf)
        reset_counts()
        res = dict(engine=engine_phase(e, raw, args.seed + 20))
        if route != "pallas" or tf:
            fs = FusedPrivateSearch(
                e, sids, np.ascontiguousarray(srows[:, :DIM]).view("<f4"),
                srows[:, DIM:DIM + M].astype(np.int64) % N, dim=DIM, m=M,
                n=N)
            fs.generator.manual_seed(args.seed + 31)
            res["fused"] = {str(G): fused_phase(fs, G, 3,
                                                args.seed + 40 + G)
                            for G in (1, 16)}
        launches[path] = read_counts(path, path_kernels(route, tf))
        paths[path] = res
        if path == "fused":
            res["k3_rescans"] = fused_rescans(e, fs, raw, args.seed + 32)
            select_ms = pir_select_times(e, (6, 96), args.seed + 50)
        del e
    path = "pallas table-free measure_comm"
    print(f"-- path {path}")
    reset_counts()
    paths[path] = measure_comm_phase(engine.db, args.seed + 60)
    launches[path] = read_counts(path, path_kernels("pallas", True))
    # the host-state engines at the main deployment, their own paths
    host, host_launches = host_engines_phase(raw, args.seed + 90,
                                             reset_counts, read_counts)
    launches.update(host_launches)
    # the private driver on every engine, its own paths
    private, private_launches = private_search_phase(
        args.seed + 95, reset_counts, read_counts)
    launches.update(private_launches)
    # the repair pins on the engine: 3,968 B entries (k = 8) on "xla", and
    # n = 5M (Hp = 14,336) on "pallas" and "fused";
    # each DB freed before the next
    for label, n, entry_bytes, routes in (
            ("3968 B", N, WIDE_ENTRY_BYTES, ("xla",)),
            ("5M", BIG_N, ENTRY_BYTES, ("pallas", "fused"))):
        u32 = entry_bytes // 4
        big_raw = synth_raw(n, u32, args.seed + 80, u32 - M, M)
        big_db = None
        for route in routes:
            path = f"{label} {route}"
            print(f"-- path {path}")
            t0 = time.perf_counter()
            e = DevicePianoEngine(n, entry_bytes, BATCH,
                                  big_raw if big_db is None else None, FAIL,
                                  device="cuda", packed_db=big_db,
                                  kernel_route=route)
            big_db = e.db
            torch.cuda.synchronize()
            ep = e.params
            print(f"DB upload+pack {time.perf_counter() - t0:.3f} s: n={n}, "
                  f"{entry_bytes} B entries, k={e.k}, C={ep.chunk_size}, "
                  f"S={ep.set_size}, Hp={ep.primary_hint_num}, "
                  f"db {big_db.numel() * 4 / 1e9:.3f} GB")
            reset_counts()
            paths[path] = dict(engine=engine_phase(e, big_raw, args.seed + 81,
                                                   preps=1, batches=3))
            launches[path] = read_counts(path, path_kernels(route, False))
            if route == "fused":
                paths[path]["k3_rescans"] = fused_rescans(
                    e, None, big_raw, args.seed + 82)
            del e
        del big_raw, big_db
        torch.cuda.empty_cache()
    # the multi-device tier as logical shards on the card, then the
    # SIFT100M deployment's per-chip shard (its own peak memory)
    multi, multi_launches = multi_device_phase(
        raw, engine.db, args.seed + 100, reset_counts, read_counts, counters)
    launches.update(multi_launches)
    peak_before = torch.cuda.max_memory_allocated()
    shard, shard_launches = sift100m_shard_phase(
        args.seed + 110, reset_counts, read_counts, counters)
    launches.update(shard_launches)
    # the plaintext paths: K6 and no PIR kernel
    for i, (path, run) in enumerate((("exact search", exact_search_phase),
                                     ("plaintext", plaintext_phase),
                                     ("knn graph", knn_graph_phase))):
        print(f"-- path {path}")
        torch.cuda.empty_cache()
        reset_counts()
        paths[path] = run(args.seed + 70 + i)
        launches[path] = read_counts(path, ("l2_distance",))
    peak_gb = max(peak_before, torch.cuda.max_memory_allocated()) / 1e9
    print(f"peak device memory over the paths {peak_gb:.3f} GB")
    # bench_torch.py's three modes at full size, K1 and K2 at its BIG shape
    bench_res, bench_launches = bench_phase(engine.db, raw, args.seed + 130,
                                            reset_counts, read_counts)
    launches.update(bench_launches)
    # the scale scripts (their own peak memory) and native_lib on the host
    del engine
    torch.cuda.empty_cache()
    scale, scale_launches = scale_phase(args.seed + 120, reset_counts,
                                        read_counts)
    launches.update(scale_launches)

    details = dict(card=card, k1=k1, k1_ragged=k1_ragged, k1_5m=k1_5m,
                   k2=k2, k2_wide=k2_wide, k2_ragged=k2_ragged, k2_5m=k2_5m,
                   k2_sliced=k2_sliced,
                   k3_k4=k34, k3_k4_hp14336=k34_wide, k3_k4_wide_s=k3_wide,
                   k4_edge=k4_edge,
                   k5=k5, k6=k6, k7=k7, paths=paths, host_engines=host,
                   private_search=private, multi_device=multi,
                   sift100m_shard=shard, scale=scale, bench=bench_res,
                   ptxas=ptxas_notes,
                   launches=launches, pir_select_ms=select_ms,
                   resident_state=resident, peak_device_gb=peak_gb,
                   seconds=time.perf_counter() - t_start)
    out_dir = Path("chiprun_out")
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(details, indent=1))
    print(f"chip_smoke: {details['seconds']:.1f} s from start to the "
          "result lines")
    total = {k: sum(n[k] for n in launches.values()) for k in KERNELS}
    k34_q96 = k34["Q=96 uniform"]

    def entry(name, source, replaces, err, res, b):
        return {"name": name, "route": "cuda",
                "source": f"pacmann_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": total[name],
                "max_abs_err": err, "ms": res["ms"],
                "plain_ms": res["plain_ms"], "bound_ms": b["bound_ms"],
                "bound_by": b["bound_by"],
                "library_ms": res.get("library_ms")}

    print(json.dumps({"kernels": [
        entry("aes_mmo_tables", "aes_mmo.cu",
              "pacmann_tpu/ops/aes_pallas.py:129",
              max(v["max_abs_err"] for v in (
                  k1, k1_ragged, k1_5m, shard["k1"], bench_res["k1_big"])),
              k1, k1),
        entry("xor_gather", "xor_gather.cu",
              "pacmann_tpu/ops/xor_scan.py:346",
              max(v["max_abs_err"] for v in (
                  *k2.values(), *k2_wide["k=5"].values(),
                  *k2_wide["k=8"].values(), k2_ragged, k2_5m,
                  *k2_sliced.values(), shard["k2"], bench_res["k2_big"])),
              k2["prep"], k2["prep"]),
        entry("claim_select", "protocol.cu",
              "pacmann_tpu/ops/protocol_kernels.py:119",
              max(v["k4_err"] for v in (*k34.values(), *k34_wide.values(),
                                        *k3_wide.values(),
                                        *k4_edge.values(),
                                        *shard["k3_k4"].values())),
              dict(ms=k34_q96["k4_ms"], plain_ms=k34_q96["k4_plain_ms"]),
              k34_q96["k4_bound"]),
        entry("select_full", "protocol.cu",
              "pacmann_tpu/ops/protocol_kernels.py:287",
              max(v["k3_err"] for v in (*k34.values(), *k34_wide.values(),
                                        *k3_wide.values(),
                                        *shard["k3_k4"].values())),
              dict(ms=k34_q96["k3_ms"], plain_ms=k34_q96["k3_plain_ms"]),
              k34_q96["k3_bound"]),
        entry("aes_mmo_points", "aes_mmo.cu",
              "pacmann_tpu/ops/aes_pallas.py:163",
              max(v["max_abs_err"] for v in k5.values()), k5["Q=96"],
              k5["Q=96"]),
        entry("l2_distance", "l2_distance.cu",
              "pacmann_tpu/ops/distance.py:91", k6["max_abs_err"], k6, k6),
        dict(entry("xor_hintgen_mm_s8p", "xor_gather.cu",
                   "pacmann_tpu/ops/attic.py:106",
                   max(v["max_abs_err"] for key, v in k7.items()
                       if key.startswith("K7a")), k7["K7a"], k7["K7a"]),
             form=k7["K7a"]["form"]),
        dict(entry("xor_hintgen_pallas", "xor_gather.cu",
                   "pacmann_tpu/ops/attic.py:187",
                   max(v["max_abs_err"] for key, v in k7.items()
                       if key.startswith("K7b")), k7["K7b"], k7["K7b"]),
             form=k7["K7b"]["form"]),
        dict(entry("xor_scan_pallas", "xor_gather.cu",
                   "pacmann_tpu/ops/attic.py:266",
                   max(v["max_abs_err"] for key, v in k7.items()
                       if key.startswith("K7c")), k7["K7c"], k7["K7c"]),
             form=k7["K7c"]["form"]),
        entry("refresh_parity", "refresh_parity.cu",
              "pacmann_tpu/ops/attic.py:355",
              max(v["max_abs_err"] for key, v in k7.items()
                  if key.startswith("K7d")), k7["K7d Q=96"],
              k7["K7d Q=96"]),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
