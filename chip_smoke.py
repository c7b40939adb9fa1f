#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU (an H100).

Drives the port's main path (pacmann_tpu_torch) once, the way bench.py
drives the JAX package, at the reference's SIFT1M-shaped deployment:
n = 1,000,000 entries of 640 B (128 f32 || 32 u32), batch 32 (16
partitions), FailureProbLog2 = 8. Phases, in order:

  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build kernels K1 (csrc/aes_mmo.cu), K2 (csrc/xor_gather.cu) and
     K3/K4 (csrc/protocol.cu), one nvcc each, all started together;
  3. each kernel against its plain torch version on the card at the main
     path's shapes, bit-equal, both timed with CUDA events: K1 also
     spot-checked against the numpy AES oracle; K3 (select_full) and K4
     (claim_select) at Q = 6 and 96 on uniform, contended and budget-edge
     rounds. Then, per protocol route ("xla", "pallas", "fused"), the CUDA
     engine + fused search against the same code on the CPU (plain
     versions) at a small size, bit-equal; and the three routes against
     each other at full size: the same answers and state over ten
     batch-96 batches;
  4. the main path, once per route, each with the launch counters set to
     0 just before it and read just after: the engine (one warm and three
     timed preprocessing runs, then ten query batches of 96 ids; every
     answered row equals its raw row, success at least 0.98), and on
     routes "xla" and "fused" fused private search, groups 1 and 16
     (max_step 20, parallel 3, k 10; fetch success within 0.03 of the
     analytic bound, params.expected_success_rate);
  5. every path launched K1 and K2, route "pallas" K4 and route "fused"
     K3, and no path the other route's kernel; then _pir_select's time
     per call on each route.

Prints a JSON line of per-kernel results, then as its last line
{"ok": true, "device": {...}}. Any failed phase raises (non-zero exit,
no result line). Without CUDA, or outside the repository, it exits
non-zero before printing any result. Run from the repository root:

    python3 chip_smoke.py [--seed N]

Details too long for the end of the output go to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import argparse
import json
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
KERNELS = ("aes_mmo_tables", "xor_gather", "claim_select", "select_full")


class SmokeFailure(RuntimeError):
    pass


def check(cond, what: str):
    if not cond:
        raise SmokeFailure(what)


def synth_raw(n: int, entry_u32: int, seed: int, float_cols: int,
              nbr_cols: int) -> np.ndarray:
    """Synthetic DB as bench.py's synth_raw builds it: one random block
    tiled, valid f32 bit patterns in the first float_cols words, distinct
    first words, and distinct uniform neighbor ids in [0, n) in the next
    nbr_cols words."""
    rng = np.random.default_rng(seed)
    block = 1 << 14
    base = rng.integers(0, 2**32, size=(block, entry_u32), dtype=np.uint32)
    base[:, :float_cols] = np.ascontiguousarray(
        rng.random((block, float_cols), dtype=np.float32)).view("<u4")
    raw = np.tile(base, ((n + block - 1) // block, 1))[:n]
    raw[:, 0] = np.arange(n, dtype=np.uint32)
    raw[:, float_cols:float_cols + nbr_cols] = rng.integers(
        0, n, size=(n, nbr_cols), dtype=np.uint32)
    return raw


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


def max_abs_err(a, b) -> int:
    return int((a.long() - b.long()).abs().max()) if a.numel() else 0


def compare_k1(seed: int, T: int, S: int, chunk_mask: int) -> dict:
    """K1 against its plain version and the numpy oracle at (16, T, S)."""
    import torch

    from pacmann_tpu_torch.ops import aes, aes_host

    rng = np.random.default_rng(seed)
    keys = [rng.bytes(16) for _ in range(16)]
    rk = aes.round_keys(keys).cuda()
    got = aes.aes_mmo_cuda(rk, T, S, chunk_mask)
    want = aes.prf_tables_plain(rk, T, S, chunk_mask)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    check(err == 0, f"K1 differs from its plain version (max err {err})")
    # spot check: 4096 lattice points against the host AES oracle
    got_np = got.cpu().numpy().view(np.uint32)
    for p in range(16):
        t = rng.integers(0, T, 256).astype(np.uint64)
        s = rng.integers(0, S, 256).astype(np.uint64)
        host = (aes_host.prf_eval_u64(aes_host.expand_key(keys[p]), t, s)
                & np.uint64(chunk_mask)).astype(np.uint32)
        check(np.array_equal(got_np[p, t.astype(np.int64), s.astype(np.int64)],
                             host), f"K1 differs from aes_host (p={p})")
    ms = cuda_ms(lambda: aes.aes_mmo_cuda(rk, T, S, chunk_mask), reps=10)
    plain_ms = cuda_ms(lambda: aes.prf_tables_plain(rk, T, S, chunk_mask),
                       reps=2)
    evals = 16 * T * S
    print(f"K1 aes_mmo_tables (16,{T},{S}): bit-equal to plain and to "
          f"aes_host on 4096 points; kernel {ms:.3f} ms "
          f"({evals / ms / 1e6:.1f} G evals/s), plain {plain_ms:.3f} ms")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, table=got)


def compare_k2(db, table, skip, quotas, seed: int) -> dict:
    """K2 against its plain version at the prep shape and at the online
    server-scan shapes (Q sub-queries per partition)."""
    import torch

    from pacmann_tpu_torch.ops import xor_scan

    S, P, CK, _ = db.shape
    k = 2
    C = CK // k
    off = torch.where(skip, xor_scan.SKIP, table).contiguous()
    shapes = {"prep": off}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    for Q in quotas:
        shapes[f"Q={Q}"] = torch.randint(0, C, (P, Q, S), generator=gen,
                                         dtype=torch.int32, device="cuda")
    res = {}
    for name, o in shapes.items():
        got = xor_scan.xor_gather_cuda(db, o, k)
        want = xor_scan.xor_gather_plain(db, o, k)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        check(err == 0, f"K2 differs from its plain version at {name}")
        del got, want
        reps = 5 if name == "prep" else 50
        ms = cuda_ms(lambda: xor_scan.xor_gather_cuda(db, o, k), reps=reps)
        plain_ms = cuda_ms(lambda: xor_scan.xor_gather_plain(db, o, k),
                           reps=2 if name == "prep" else 10)
        gb = o.numel() * k * 512 / 1e9        # entries gathered (upper bound)
        print(f"K2 xor_gather {name} offsets {tuple(o.shape)}: bit-equal to "
              f"plain; kernel {ms:.3f} ms ({gb / ms * 1e3:.1f} GB/s of "
              f"gathered entries), plain {plain_ms:.3f} ms")
        res[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
    return res


def protocol_inputs(gen, kind: str, Q: int, table, p, P: int,
                    psize: int) -> list:
    """Full-width K3 inputs on the card: the prep's slot columns and
    offset table, random program points (half unset), tags, replacement
    indices, budgets and dummy rows; idx_q (Q, P) local ids with 10 %
    dummy rounds. kind "contended": every round of a partition asks one
    id; "budget": one replacement left in every chunk (hist = R - 1), two
    admissions left (finished = max_q - 2) and rounds repeating chunks."""
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
    idx_q[torch.rand((Q, P), generator=gen, device="cuda") < 0.1] = -1
    return [slot_col, prog, ri(T, P, Hp), table, repl_idx, hist, finished,
            idx_q, ri(C, Q, P, S)]


def compare_protocol(table, p, P: int, psize: int, quotas,
                     seed: int) -> dict:
    """K3 and K4 against their plain versions at the main path's shapes,
    every output bit-equal; times of the uniform case (CUDA events)."""
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
        for kind in ("uniform", "contended", "budget"):
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
                       found=found, real=int(real.sum()))
            if kind == "uniform":
                row.update(
                    k3_ms=cuda_ms(lambda: pk.select_full_cuda(*a, **kw), 50),
                    k3_plain_ms=cuda_ms(
                        lambda: pk.select_full_plain(*a, **kw), 3),
                    k4_ms=cuda_ms(lambda: pk.claim_select_cuda(
                        *claim_args, C=p.chunk_size, dpp=DPP), 50),
                    k4_plain_ms=cuda_ms(lambda: pk.claim_select_plain(
                        *claim_args, C=p.chunk_size, dpp=DPP), 3))
                times = (f"; K3 kernel {row['k3_ms']:.4f} ms, plain "
                         f"{row['k3_plain_ms']:.3f} ms; K4 kernel "
                         f"{row['k4_ms']:.4f} ms, plain "
                         f"{row['k4_plain_ms']:.3f} ms")
            else:
                times = ""
            print(f"K3 select_full + K4 claim_select Q={Q} {kind}: bit-equal "
                  f"to plain ({row['real']} real rounds, {found} found, "
                  f"{served} served){times}")
            res[f"Q={Q} {kind}"] = row
    return res


def small_parity(seed: int, route: str):
    """The CUDA path (kernels) and the CPU path (plain versions) of the
    engine and the fused search on one protocol route, same seeds, small
    size: identical state, answers and counters."""
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
                              kernel_route=route)
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
    print(f"small-input parity, route {route}: CUDA path == CPU plain path "
          "(prep state, 3 query batches, fused search ids/steps/stats, "
          "final state)")


def route_identity(db, raw: np.ndarray, seed: int, batches: int = 10):
    """One engine per protocol route on the same DB and seeds: identical
    answers, and identical state after every batch of 96 ids."""
    import torch

    from pacmann_tpu_torch.pir.device_engine import DevicePianoEngine

    engines = {}
    for route in ROUTES:
        e = DevicePianoEngine(N, ENTRY_BYTES, BATCH, None, FAIL,
                              packed_db=db, kernel_route=route)
        e.preprocessing(rng=np.random.default_rng(seed))
        engines[route] = e
    rng = np.random.default_rng(seed + 1)
    keys = ("tag", "prog", "primary_parity", "slot_col", "hist", "finished")
    for b in range(batches):
        ids = [int(i) for i in rng.integers(0, N, 96)]
        outs = {r: e.query(ids) for r, e in engines.items()}
        ref = engines["xla"].state
        for r in ROUTES[1:]:
            check(np.array_equal(outs[r], outs["xla"]),
                  f"route {r}: answers differ from route xla, batch {b}")
            for key in keys:
                check(torch.equal(engines[r].state[key], ref[key]),
                      f"route {r}: state {key} differs from xla, batch {b}")
    print(f"route identity at full size: {', '.join(ROUTES)} give the same "
          f"answers and state ({', '.join(keys)}) after each of {batches} "
          "batches of 96 ids")


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


def engine_phase(engine, raw: np.ndarray, seed: int) -> dict:
    """Preprocessing (1 warm + 3 timed) and ten timed 96-id batches."""
    engine.preprocessing(rng=np.random.default_rng(seed + 1))
    preps = []
    for i in range(3):
        t0 = time.perf_counter()
        engine.preprocessing(rng=np.random.default_rng(seed + 2 + i))
        preps.append(time.perf_counter() - t0)
    rng = np.random.default_rng(seed + 3)
    n = raw.shape[0]
    engine.query([int(i) for i in rng.integers(0, n, 96)])     # warm
    batches, lat = [], []
    for _ in range(10):
        ids = [int(i) for i in rng.integers(0, n, 96)]
        t0 = time.perf_counter()
        out = engine.query(ids)
        lat.append(time.perf_counter() - t0)
        batches.append((ids, out))
    exact = total = 0
    for ids, out in batches:
        want = raw[ids]
        for r in range(len(ids)):
            total += 1
            if np.array_equal(out[r], want[r]):
                exact += 1
            else:
                check(not out[r].any(), f"row {ids[r]} answered wrongly")
    rate = exact / total
    print(f"engine prep s: {', '.join(f'{t:.4f}' for t in preps)} "
          f"(min {min(preps):.4f})")
    print(f"engine query batch96 ms: median {np.median(lat) * 1e3:.3f}, "
          f"min {min(lat) * 1e3:.3f}, max {max(lat) * 1e3:.3f} (10 batches); "
          f"exact rows {exact}/{total} = {rate:.4f}; every other row zero")
    check(rate >= 0.98, f"batch-96 success {rate:.4f} < 0.98")
    return dict(prep_s=preps, batch96_ms=[t * 1e3 for t in lat],
                batch96_success=rate)


def fused_phase(fs, G: int, reps: int, seed: int) -> dict:
    """One warm and `reps` timed searches of a G-query group."""
    from pacmann_tpu_torch.pir.params import expected_success_rate

    e = fs.engine
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
    P = e.config.partition_num
    quota = G * 3 * M // P
    want_step = int(round(fs.fetch_stats[0] / (reps * 20)))
    bound = expected_success_rate(want_step, P, quota, FAIL)
    succ = fs.fetch_success_rate()
    ms_q = [c * 1e3 / G for c in comp]
    print(f"fused group {G}: ms/query median {np.median(ms_q):.3f}, min "
          f"{min(ms_q):.3f} ({reps} searches of 20 steps); maintenance "
          f"{fs.maintenance_s * 1e3 / (reps * G):.3f} ms/query over "
          f"{fs.refreshes} refreshes; fetch success {succ:.4f} vs bound "
          f"{bound:.4f} (wanted/step {want_step}, quota {quota})")
    check(abs(succ - bound) <= 0.03,
          f"group {G}: fetch success {succ:.4f} is not within 0.03 of "
          f"the bound {bound:.4f}")
    return dict(ms_per_query=ms_q, fetch_success=succ, bound=bound,
                refreshes=fs.refreshes)


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
        from pacmann_tpu_torch.ops import aes, xor_scan
        from pacmann_tpu_torch.ops import protocol_kernels as pk
        from pacmann_tpu_torch.pir.device_engine import (
            DevicePianoEngine, _build_skip)
        from pacmann_tpu_torch.private.fused_search import FusedPrivateSearch
        from pacmann_tpu_torch.utils import cuda_lib
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
    names = ("aes_mmo", "xor_gather", "protocol")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(cuda_lib.load, names))
    print(f"build: {time.perf_counter() - t0:.2f} s for {len(names)} "
          "sources in parallel")
    for name in names:
        note = cuda_lib.BUILD / f"{name}.ptxas.txt"
        ptxas = [ln.strip() for ln in note.read_text().splitlines()
                 if "registers" in ln] if note.exists() else []
        print(f"build {name}: nvcc "
              f"{cuda_lib.build_seconds.get(name, 0.0):.2f} s "
              + " | ".join(ptxas))

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
    table = k1.pop("table")
    skip = _build_skip(P, T, Hp, R, S, engine.device)
    k2 = compare_k2(engine.db, table, skip, (6, 96), args.seed + 11)
    k34 = compare_protocol(table, p, P, c.partition_size, (6, 96),
                           args.seed + 13)
    del table, skip
    torch.cuda.empty_cache()
    for route in ROUTES:
        small_parity(args.seed + 12, route)
    route_identity(engine.db, raw, args.seed + 14)
    torch.cuda.empty_cache()

    # 4. the main path once per route, launch counters from zero for each
    counters = {"aes_mmo_tables": aes.aes_mmo_cuda,
                "xor_gather": xor_scan.xor_gather_cuda,
                "claim_select": pk.claim_select_cuda,
                "select_full": pk.select_full_cuda}
    own = {"xla": (), "pallas": ("claim_select",), "fused": ("select_full",)}
    sids = np.random.default_rng(args.seed + 30).choice(N, 1000,
                                                        replace=False)
    srows = raw[sids]
    paths, launches = {}, {}
    torch.cuda.reset_peak_memory_stats()
    for route in ROUTES:
        print(f"-- path {route}")
        e = DevicePianoEngine(N, ENTRY_BYTES, BATCH, None, FAIL,
                              packed_db=engine.db, kernel_route=route)
        for fn in counters.values():
            fn.launches = 0
        res = dict(engine=engine_phase(e, raw, args.seed + 20))
        if route != "pallas":
            fs = FusedPrivateSearch(
                e, sids, np.ascontiguousarray(srows[:, :DIM]).view("<f4"),
                srows[:, DIM:DIM + M].astype(np.int64) % N, dim=DIM, m=M,
                n=N)
            fs.generator.manual_seed(args.seed + 31)
            res["fused"] = {str(G): fused_phase(fs, G, 3,
                                                args.seed + 40 + G)
                            for G in (1, 16)}
        torch.cuda.synchronize()
        launches[route] = {k: fn.launches for k, fn in counters.items()}
        print(f"path {route} launches: {launches[route]}")
        for name, count in launches[route].items():
            if name in ("aes_mmo_tables", "xor_gather") or name in own[route]:
                check(count > 0, f"kernel {name} was not launched on path "
                      f"{route}")
            else:
                check(count == 0, f"path {route} launched {name}")
        paths[route] = res
        if route == "fused":
            select_ms = pir_select_times(e, (6, 96), args.seed + 50)
        del e
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"peak device memory over the paths {peak_gb:.3f} GB")

    details = dict(card=card, k1=k1, k2=k2, k3_k4=k34, paths=paths,
                   launches=launches, pir_select_ms=select_ms,
                   peak_device_gb=peak_gb,
                   seconds=time.perf_counter() - t_start)
    out_dir = Path("chiprun_out")
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(details, indent=1))
    total = {k: sum(launches[r][k] for r in ROUTES) for k in KERNELS}
    k2_err = max(v["max_abs_err"] for v in k2.values())
    k34_q96 = k34["Q=96 uniform"]
    print(json.dumps({"kernels": [
        {"name": "aes_mmo_tables", "route": "cuda",
         "source": "pacmann_tpu_torch/csrc/aes_mmo.cu",
         "replaces": "pacmann_tpu/ops/aes_pallas.py:129",
         "launches": total["aes_mmo_tables"],
         "max_abs_err": k1["max_abs_err"], "ms": k1["ms"],
         "plain_ms": k1["plain_ms"]},
        {"name": "xor_gather", "route": "cuda",
         "source": "pacmann_tpu_torch/csrc/xor_gather.cu",
         "replaces": "pacmann_tpu/ops/xor_scan.py:346",
         "launches": total["xor_gather"], "max_abs_err": k2_err,
         "ms": k2["prep"]["ms"], "plain_ms": k2["prep"]["plain_ms"]},
        {"name": "claim_select", "route": "cuda",
         "source": "pacmann_tpu_torch/csrc/protocol.cu",
         "replaces": "pacmann_tpu/ops/protocol_kernels.py:119",
         "launches": total["claim_select"],
         "max_abs_err": max(v["k4_err"] for v in k34.values()),
         "ms": k34_q96["k4_ms"], "plain_ms": k34_q96["k4_plain_ms"]},
        {"name": "select_full", "route": "cuda",
         "source": "pacmann_tpu_torch/csrc/protocol.cu",
         "replaces": "pacmann_tpu/ops/protocol_kernels.py:287",
         "launches": total["select_full"],
         "max_abs_err": max(v["k3_err"] for v in k34.values()),
         "ms": k34_q96["k3_ms"], "plain_ms": k34_q96["k3_plain_ms"]},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
