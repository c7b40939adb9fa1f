#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU (an H100).

Drives the port's main path (pacmann_tpu_torch) once, the way bench.py
drives the JAX package, at the reference's SIFT1M-shaped deployment:
n = 1,000,000 entries of 640 B (128 f32 || 32 u32), batch 32 (16
partitions), FailureProbLog2 = 8. Phases, in order:

  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build kernels K1 (csrc/aes_mmo.cu) and K2 (csrc/xor_gather.cu);
  3. each kernel against its plain torch version on the card at the main
     path's shapes (bit-equal; both times), K1 spot-checked against the
     numpy AES oracle, and the CUDA engine + fused search against the same
     code on the CPU (plain versions) at a small size, bit-equal;
  4. the engine: one warm and three timed preprocessing runs, then ten
     query batches of 96 ids — every answered row equals its raw row and
     the success rate is at least 0.98;
  5. fused private search, groups 1 and 16 (max_step 20, parallel 3,
     k 10): ms per query, and the measured fetch success within 0.03 of
     the analytic bound (params.expected_success_rate);
  6. the launch counters of K1 and K2 over phases 4-5 are nonzero.

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
from pathlib import Path

import numpy as np

DIM, M = 128, 32                      # 128 f32 || 32 u32 neighbor ids
ENTRY_BYTES = 4 * (DIM + M)
N, BATCH, FAIL = 1_000_000, 32, 8


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


def small_parity(seed: int):
    """The CUDA path (kernels) and the CPU path (plain versions) of the
    engine and the fused search, same seeds, small size: identical state,
    answers and counters."""
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
        e = DevicePianoEngine(n, 4 * (d + m), m, raw, 8, device=dev)
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
    print("small-input parity: CUDA path == CPU plain path (prep state, 3 "
          "query batches, fused search ids/steps/stats, final state)")


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

    # 2. build
    for name in ("aes_mmo", "xor_gather"):
        t0 = time.perf_counter()
        cuda_lib.load(name)
        note = cuda_lib.BUILD / f"{name}.ptxas.txt"
        ptxas = [ln.strip() for ln in note.read_text().splitlines()
                 if "registers" in ln] if note.exists() else []
        print(f"build {name}: {time.perf_counter() - t0:.2f} s "
              f"(nvcc {cuda_lib.build_seconds.get(name, 0.0):.2f} s) "
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

    # 3. kernels against their plain versions at the main path's shapes
    k1 = compare_k1(args.seed + 10, T, S, p.chunk_mask)
    skip = _build_skip(P, T, Hp, R, S, engine.device)
    k2 = compare_k2(engine.db, k1.pop("table"), skip, (6, 96),
                    args.seed + 11)
    torch.cuda.empty_cache()
    small_parity(args.seed + 12)

    # 4-5. the main path, with launch counters from zero
    aes.aes_mmo_cuda.launches = 0
    xor_scan.xor_gather_cuda.launches = 0
    torch.cuda.reset_peak_memory_stats()
    eng = engine_phase(engine, raw, args.seed + 20)
    sids = np.random.default_rng(args.seed + 30).choice(N, 1000,
                                                        replace=False)
    srows = raw[sids]
    fs = FusedPrivateSearch(
        engine, sids, np.ascontiguousarray(srows[:, :DIM]).view("<f4"),
        srows[:, DIM:DIM + M].astype(np.int64) % N, dim=DIM, m=M, n=N)
    fs.generator.manual_seed(args.seed + 31)
    fused = {G: fused_phase(fs, G, 3, args.seed + 40 + G) for G in (1, 16)}
    torch.cuda.synchronize()
    launches = {"aes_mmo_tables": aes.aes_mmo_cuda.launches,
                "xor_gather": xor_scan.xor_gather_cuda.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"main-path launches: {launches}; peak device memory "
          f"{peak_gb:.3f} GB")
    for name, count in launches.items():
        check(count > 0, f"kernel {name} was not launched on the main path")

    details = dict(card=card, k1=k1, k2=k2, engine=eng,
                   fused={str(g): v for g, v in fused.items()},
                   launches=launches, peak_device_gb=peak_gb,
                   seconds=time.perf_counter() - t_start)
    out_dir = Path("chiprun_out")
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(details, indent=1))
    k2_err = max(v["max_abs_err"] for v in k2.values())
    print(json.dumps({"kernels": [
        {"name": "aes_mmo_tables", "route": "cuda",
         "source": "pacmann_tpu_torch/csrc/aes_mmo.cu",
         "replaces": "pacmann_tpu/ops/aes_pallas.py:129",
         "launches": launches["aes_mmo_tables"],
         "max_abs_err": k1["max_abs_err"], "ms": k1["ms"],
         "plain_ms": k1["plain_ms"]},
        {"name": "xor_gather", "route": "cuda",
         "source": "pacmann_tpu_torch/csrc/xor_gather.cu",
         "replaces": "pacmann_tpu/ops/xor_scan.py:346",
         "launches": launches["xor_gather"], "max_abs_err": k2_err,
         "ms": k2["prep"]["ms"], "plain_ms": k2["prep"]["plain_ms"]},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
