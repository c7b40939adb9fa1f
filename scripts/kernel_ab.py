#!/usr/bin/env python3
"""A/B of the port's kernels K1-K5 and K7a-K7c on one NVIDIA GPU.

Times the kernels of this tree and of a base tree (another checkout, e.g.
a `git archive` of the parent commit unpacked into a git-ignored
directory) in the turns base, tree, tree, base. Each turn is a process of
its own that imports its tree's pacmann_tpu_torch, so each tree's wrappers
build and launch its own csrc/, while the inputs and the timing are this
tree's chip_smoke.py helpers for both (the base's chip_smoke.py may time
fewer shapes, or none replayed from a CUDA graph, which is the only
device-only time of short kernels). Shapes: the SIFT1M deployment's (n = 1M
entries of 640 B, batch 32; K3/K4 at Q = 6, 96 and 384), the batch-PIR
store's (3,201,821 entries of 896 B, batch 32: K3/K4 at Q = 2, Hp =
7,168, S = 196, C = 1,024) and the pins n = 5M (K1) and n = 7M (K3/K4 at
Hp = 14,336); back-to-back calls (CUDA events) and calls replayed from a
CUDA graph (device time); K4 also over the 7M pin's whole budget (Q =
max_query_num), its replay wherever the tree's plan needs no opt-in above
48 KiB; where the tree's aes_mmo.cu has one, an empty kernel of K5's Q =
6 launch shape, replayed (the launch floor). The gather group: K2's
chunk-major form at the 1M prep (K1's table and the skip mask) at k = 2,
5 and 8 on random DBs; K7a on the byte planes of the k = 2 and k = 5 DBs
with the same offsets (skips folded in); K7b on the k = 2 and k = 5 DBs
with K1's table and the skip mask beside it; K7c on the flat
single-server layout (B = 57,632, S = 492, C = 2,048, skip 25 %), the
entry points' choice of form (a tree whose wrappers take a form also
times the row form); K2 at the preps whose C is above the chunk form's:
the SIFT100M shard's (4, 179,584, 764, C = 8,192), bench's BIG (16,
24,416, 196, C = 1,024) and the 5M pin's (16, 35,552, 156, C = 2,048),
K1's table and the skip mask on random DBs, in the entry point's form
(the row form in a tree without the sliced one) and the row form, beside
gather_bound. Every result is held against its plain version.
--groups picks "pir" (K1, K3, K4, K5) and/or "gather" (K2, K7a-K7c).
With --phases it then times this tree's phases: K3's, from protocol.cu
built with -DK3_PHASE_CLOCKS, whose marks record the SM clock (clock64)
of CTA 0 of partition 0 around each cluster barrier, summed over the
windows; K5's block setup, from aes_mmo.cu built with -DAES_FILL_CLOCKS
(the SM clock of block (0, 0) after its 64 KB image and after round 1's
fold); and the staged gather's (K2's chunk form, K7a's, K7b's and K7c's
staged forms), from xor_gather.cu built with -DXOR_PHASE_CLOCKS (thread
0 of CTA (0, 0, 0): SM clocks waiting for a stage, on the offset runs,
issuing copies, gathering, in the epilogue), with each staged call's
device time per kernel from torch.profiler.

    python3 scripts/kernel_ab.py --base DIR [--groups pir,gather] [--phases]

Prints one line per measurement and writes chiprun_out/kernel_ab.json.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PHASES = ("phase1", "sync1", "walk", "sync2", "phase3")
# the batch-PIR store of the upstream's TestBatchPIRPerf (batch 32): K3's
# and K4's shape in its batches' rounds, Q = 2 at Hp = 7,168, S = 196
BIG3P2M_N, BIG3P2M_ENTRY_BYTES = 3_201_821, 896


def cases(cs, aes, pk, gen) -> tuple[list, list, list, list]:
    """K1, K5, K3/K4 and K4-only cases: (label, arguments...) on the
    card."""
    from pacmann_tpu_torch.pir.params import DEFAULT_PROGRAM_POINT as DPP
    from pacmann_tpu_torch.pir.params import (derive_batch_params,
                                              derive_piano_params)

    def params(n, entry_bytes=cs.ENTRY_BYTES):
        c = derive_batch_params(n, entry_bytes, cs.BATCH, cs.FAIL)
        return c, derive_piano_params(c.partition_size, entry_bytes,
                                      cs.FAIL)

    rk = aes.round_keys([bytes([i]) * 16 for i in range(16)]).cuda()
    k1, k3, k5, k4 = [], [], [], []
    for label, n in (("1M", cs.N), ("5M", cs.BIG_N)):
        _, p = params(n)
        T = p.primary_hint_num + p.set_size * p.max_query_per_chunk
        k1.append((label, rk, T, p.set_size, p.chunk_mask))
    for label, n, entry_bytes, quotas in (
            ("3584", cs.N, cs.ENTRY_BYTES, (6, 96, 384)),
            ("7168", BIG3P2M_N, BIG3P2M_ENTRY_BYTES, (2,)),
            ("14336", cs.PROTOCOL_PIN_N, cs.ENTRY_BYTES, (6, 96))):
        c, p = params(n, entry_bytes)
        T = p.primary_hint_num + p.set_size * p.max_query_per_chunk
        table = aes.aes_mmo_cuda(rk, T, p.set_size, p.chunk_mask)
        kw = dict(C=p.chunk_size, R=p.max_query_per_chunk,
                  Hp=p.primary_hint_num, S=p.set_size,
                  max_q=p.max_query_num, dpp=DPP)
        for Q in quotas:
            if label == "3584" and Q < 384:
                tags, xs = cs.k5_points(gen, c.partition_num, Q, p.set_size,
                                        p.primary_hint_num, T)
                k5.append((f"Q={Q}", rk, tags, xs, p.chunk_mask))
            for kind in ("uniform", "deep"):
                a = cs.protocol_inputs(gen, kind, Q, table, p,
                                       c.partition_num, c.partition_size)
                k3.append((f"{label} Q={Q} {kind}", a, kw,
                           pk.select_full_plain(*a, **kw)))
        if label == "14336":
            # the pin's whole budget in one claim: K4's inputs
            a = cs.protocol_inputs(gen, "uniform", p.max_query_num, table, p,
                                   c.partition_num, c.partition_size)
            idx = a[7]
            u = idx.clamp(min=0)
            k4.append((f"{label} Q={p.max_query_num} uniform",
                       (a[0], a[1], u // p.chunk_size, u % p.chunk_size,
                        idx >= 0), p.chunk_size))
            del a
        del table
    return k1, k5, k3, k4


def gather_cases(cs, gen) -> tuple[list, list, list, list]:
    """K2, K7a, K7b and K7c cases on the card: (label, inputs...). K2, K7a
    and K7b share the 1M prep's offsets (K1's table; the skip mask folded
    in, -1 for K2 and C for K7a, or beside it for K7b) on random DBs of k
    rows; K7c is chip_smoke.py's flat layout."""
    import torch

    from pacmann_tpu_torch.ops import aes, attic
    from pacmann_tpu_torch.pir.device_engine import _build_skip
    from pacmann_tpu_torch.pir.params import (derive_batch_params,
                                              derive_piano_params)

    c = derive_batch_params(cs.N, cs.ENTRY_BYTES, cs.BATCH, cs.FAIL)
    p = derive_piano_params(c.partition_size, cs.ENTRY_BYTES, cs.FAIL)
    S, Hp, R, C = (p.set_size, p.primary_hint_num, p.max_query_per_chunk,
                   p.chunk_size)
    T, P = Hp + S * R, c.partition_num
    rk = aes.round_keys([bytes([i]) * 16 for i in range(P)]).cuda()
    table = aes.aes_mmo_cuda(rk, T, S, p.chunk_mask)
    skip = _build_skip(P, T, Hp, R, S, "cuda")
    k2_off = torch.where(skip, -1, table).contiguous()
    k7a_off = torch.where(skip, C, table).contiguous()
    skip = skip.contiguous()
    k2, k7a, k7b = [], [], []
    for k in (2, 5, 8):
        db = torch.empty((S, P, C * k, 128), dtype=torch.int32,
                         device="cuda").random_(-2**31, 2**31, generator=gen)
        k2.append((f"k={k}", db, k2_off, k))
        if k < 8:
            k7a.append((f"k={k}", attic.to_plane_major_s8(db, k), k7a_off))
            k7b.append((f"k={k}", db, table, skip, k))
    flat = torch.empty((cs.FLAT_S, cs.FLAT_C * 2, 128), dtype=torch.int32,
                       device="cuda").random_(-2**31, 2**31, generator=gen)
    f_off = torch.randint(0, cs.FLAT_C, (cs.FLAT_B, cs.FLAT_S),
                          generator=gen, dtype=torch.int32, device="cuda")
    f_skip = torch.rand((cs.FLAT_B, cs.FLAT_S), generator=gen,
                        device="cuda") < 0.25
    return k2, k7a, k7b, [(f"B={cs.FLAT_B}", flat, f_off, f_skip, 2)]


# K2's preps above the chunk form's C: (label, n, entry bytes, batch)
K2_PREPS = (("shard", 25_000_000, 640, 8), ("BIG", 3_201_821, 896, 32),
            ("5M", 5_000_000, 640, 32))


def k2_prep_turn(cs, res: dict) -> None:
    """K2 at K2_PREPS: K1's table of the deployment's parameters with the
    engine's skip mask, on a random DB, in the entry point's form and the
    row form, each held against its plain version and timed with CUDA
    events; "... bound" is gather_bound of the offsets."""
    import torch

    from pacmann_tpu_torch.ops import aes, xor_scan
    from pacmann_tpu_torch.pir import layout
    from pacmann_tpu_torch.pir.device_engine import _build_skip
    from pacmann_tpu_torch.pir.params import (derive_batch_params,
                                              derive_piano_params)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(9)
    for label, n, entry_bytes, batch in K2_PREPS:
        c = derive_batch_params(n, entry_bytes, batch, cs.FAIL)
        p = derive_piano_params(c.partition_size, entry_bytes, cs.FAIL)
        S, Hp, R, C = (p.set_size, p.primary_hint_num,
                       p.max_query_per_chunk, p.chunk_size)
        T, P = Hp + S * R, c.partition_num
        k = layout.entry_rows(entry_bytes // 4)
        rk = aes.round_keys([bytes([i]) * 16 for i in range(P)]).cuda()
        off = torch.where(_build_skip(P, T, Hp, R, S, "cuda"), xor_scan.SKIP,
                          aes.aes_mmo_cuda(rk, T, S, p.chunk_mask)
                          ).contiguous()
        db = torch.empty((S, P, C * k, 128), dtype=torch.int32,
                         device="cuda").random_(-2**31, 2**31, generator=gen)
        want = xor_scan.xor_gather_plain(db, off, k)
        calls = {"": lambda: xor_scan.xor_gather_cuda(db, off, k),
                 " row": lambda: xor_scan.xor_gather_cuda(db, off, k,
                                                          form="row")}
        print(f"K2 {label} prep (P={P}, B={T}, S={S}, C={C}, k={k}): the "
              f"entry point's form {xor_scan.gather_form(P, T, S, C, k)}",
              flush=True)
        for form, call in calls.items():
            cs.check(torch.equal(call(), want),
                     f"K2 {label} prep{form} differs from its plain version")
            res[f"K2 {label} prep{form}"] = (cs.cuda_ms(call, 3), None)
        res[f"K2 {label} prep bound"] = (
            cs.gather_bound(off, None, C, k)[0]["bound_ms"], None)
        del db, off, want
        torch.cuda.empty_cache()


def gather_turn(cs, res: dict) -> None:
    """The gather group of one turn: K2's chunk form, K7a, K7b and K7c
    (the entry point's form; also the row form where the wrappers take
    one), each held against its plain version, timed with CUDA events."""
    import inspect

    import torch

    from pacmann_tpu_torch.ops import attic, xor_scan

    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    k2, k7a, k7b, k7c = gather_cases(cs, gen)

    def takes_form(fn) -> bool:
        return "form" in inspect.signature(fn).parameters

    forms = takes_form(attic.xor_scan_pallas_cuda)
    for label, db, off, k in k2:
        got = xor_scan.xor_gather_cuda(db, off, k, form="chunk")
        cs.check(torch.equal(got, xor_scan.xor_gather_plain(db, off, k)),
                 f"K2 chunk {label} differs from its plain version")
        del got
        res[f"K2 chunk {label}"] = (cs.cuda_ms(
            lambda: xor_scan.xor_gather_cuda(db, off, k, form="chunk"), 5),
            None)
    for label, dbp, off in k7a:
        want = attic.xor_hintgen_mm_s8p_plain(dbp, off)
        calls = {"": lambda: attic.xor_hintgen_mm_s8p_cuda(dbp, off)}
        if forms:
            calls[" row"] = lambda: attic.xor_hintgen_mm_s8p_cuda(
                dbp, off, form="row")
        for form, call in calls.items():
            cs.check(torch.equal(call(), want),
                     f"K7a{form} {label} differs from its plain version")
            res[f"K7a{form} {label}"] = (cs.cuda_ms(call, 5), None)
        del want
    for label, db, table, skip, k in k7b:
        want = attic.xor_hintgen_pallas_plain(db, table, skip, k)
        calls = {"": lambda: attic.xor_hintgen_pallas_cuda(db, table, skip,
                                                           k)}
        if takes_form(attic.xor_hintgen_pallas_cuda):
            calls[" row"] = lambda: attic.xor_hintgen_pallas_cuda(
                db, table, skip, k, form="row")
        for form, call in calls.items():
            cs.check(torch.equal(call(), want),
                     f"K7b{form} {label} differs from its plain version")
            res[f"K7b{form} {label}"] = (cs.cuda_ms(call, 5), None)
        del want
    for label, db, off, skip, k in k7c:
        want = attic.xor_scan_pallas_plain(db, off, skip, k)
        calls = {"": lambda: attic.xor_scan_pallas_cuda(db, off, skip, k)}
        if forms:
            calls[" row"] = lambda: attic.xor_scan_pallas_cuda(
                db, off, skip, k, form="row")
        for form, call in calls.items():
            cs.check(torch.equal(call(), want),
                     f"K7c{form} {label} differs from its plain version")
            res[f"K7c{form} {label}"] = (cs.cuda_ms(call, 5), None)
        del want
    del k2, k7a, k7b, k7c
    torch.cuda.empty_cache()
    k2_prep_turn(cs, res)


def turn(tree: Path, groups: tuple) -> dict:
    """One turn: this process times `tree`'s kernels of `groups`, with
    this tree's chip_smoke.py helpers."""
    sys.path[:0] = [str(ROOT)]
    import torch

    import chip_smoke as cs
    sys.path[:0] = [str(tree)]
    from pacmann_tpu_torch.ops import aes
    from pacmann_tpu_torch.ops import protocol_kernels as pk
    from pacmann_tpu_torch.pir.params import DEFAULT_PROGRAM_POINT as DPP

    assert Path(pk.__file__).resolve().is_relative_to(tree.resolve())
    res = {}
    if "gather" in groups:
        gather_turn(cs, res)
        torch.cuda.empty_cache()
    if "pir" not in groups:
        return res
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    k1, k5, k3, k4 = cases(cs, aes, pk, gen)
    # the base tree's K4 plan may need an opt-in above 48 KiB, where a CUDA
    # graph cannot be captured around its first launch
    k4_plan = getattr(pk, "smem_bytes", None)

    def k4_replays(Hp, S):
        return k4_plan is None or k4_plan(Hp, S) <= 48 * 1024
    for label, rk, T, S, mask in k1:
        got = aes.aes_mmo_cuda(rk, T, S, mask)
        cs.check(torch.equal(got, aes.prf_tables_plain(rk, T, S, mask)),
                 f"{tree}: K1 {label} differs from its plain version")
        del got

        def k1_call():
            return aes.aes_mmo_cuda(rk, T, S, mask)
        res[f"K1 {label}"] = (cs.cuda_ms(k1_call, 10),
                              cs.graph_ms(k1_call, 5))
    for label, rk, tags, xs, mask in k5:
        cs.check(torch.equal(aes.aes_mmo_points_cuda(rk, tags, xs, mask),
                             aes.prf_eval_plain(rk, tags, xs, mask)),
                 f"{tree}: K5 {label} differs from its plain version")

        def k5_call():
            return aes.aes_mmo_points_cuda(rk, tags, xs, mask)
        res[f"K5 {label}"] = (cs.cuda_ms(k5_call, 50),
                              cs.graph_ms(k5_call, 50))
    try:
        res["K5 floor Q=6"] = (None, cs.k5_floor_ms(*k5[0][2].shape))
    except AttributeError:             # a tree without the empty kernel
        pass
    for label, a, kw, (sel_p, qs_p) in k3:
        sel, qs = pk.select_full_cuda(*a, **kw)
        cs.check(torch.equal(qs, qs_p) and all(
            torch.equal(x, y) for x, y in zip(sel, sel_p)),
            f"{tree}: K3 {label} differs from its plain version")
        claim = (a[0], a[1], sel_p[4], sel_p[5] % kw["C"], a[7] >= 0)
        hit, fnd = pk.claim_select_cuda(*claim, C=kw["C"], dpp=DPP)
        hit_p, fnd_p = pk.claim_select_plain(*claim, C=kw["C"], dpp=DPP)
        cs.check(torch.equal(hit, hit_p) and torch.equal(fnd, fnd_p),
                 f"{tree}: K4 {label} differs from its plain version")

        def k3_call():
            return pk.select_full_cuda(*a, **kw)

        def k4_call():
            return pk.claim_select_cuda(*claim, C=kw["C"], dpp=DPP)
        res[f"K3 {label}"] = (cs.cuda_ms(k3_call, 50),
                              cs.graph_ms(k3_call, 50))
        res[f"K4 {label}"] = (cs.cuda_ms(k4_call, 50), cs.graph_ms(
            k4_call, 50) if k4_replays(kw["Hp"], kw["S"]) else None)
    for label, claim, C in k4:
        hit_p, fnd_p = pk.claim_select_plain(*claim, C=C, dpp=DPP)
        hit, fnd = pk.claim_select_cuda(*claim, C=C, dpp=DPP)
        cs.check(torch.equal(hit, hit_p) and torch.equal(fnd, fnd_p),
                 f"{tree}: K4 {label} differs from its plain version")

        def k4_call():
            return pk.claim_select_cuda(*claim, C=C, dpp=DPP)
        Hp, S = claim[0].shape[2], claim[0].shape[1]
        res[f"K4 {label}"] = (cs.cuda_ms(k4_call, 10), cs.graph_ms(
            k4_call, 10) if k4_replays(Hp, S) else None)
    return res


def gather_phases(cs, nvcc: str) -> dict:
    """The staged gather's phases in this tree: each staged call's device
    time per kernel (torch.profiler), then thread 0 of CTA (0, 0, 0)'s SM
    clocks per phase, from xor_gather.cu built with -DXOR_PHASE_CLOCKS and
    put in place of the wrappers' build."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pacmann_tpu_torch.ops import attic, xor_scan
    from pacmann_tpu_torch.utils import cuda_lib

    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    k2, k7a, k7b, k7c = gather_cases(cs, gen)
    calls = {f"K2 chunk {label}": (
        lambda db=db, off=off, k=k: xor_scan.xor_gather_cuda(
            db, off, k, form="chunk")) for label, db, off, k in k2}
    calls.update({f"K7a staged {label}": (
        lambda dbp=dbp, off=off: attic.xor_hintgen_mm_s8p_cuda(
            dbp, off, form="staged")) for label, dbp, off in k7a})
    calls.update({f"K7b staged {label}": (
        lambda db=db, table=table, skip=skip, k=k:
        attic.xor_hintgen_pallas_cuda(db, table, skip, k, form="staged"))
        for label, db, table, skip, k in k7b})
    calls.update({f"K7c staged {label}": (
        lambda db=db, off=off, skip=skip, k=k: attic.xor_scan_pallas_cuda(
            db, off, skip, k, form="staged"))
        for label, db, off, skip, k in k7c})
    res = {}
    for name, call in calls.items():
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                call()
            torch.cuda.synchronize()
        per_kernel = {ev.key.split("(")[0]: ev.device_time_total / 3e3
                      for ev in prof.key_averages()
                      if ev.device_time_total > 0}
        res[name] = dict(device_ms=per_kernel)
        print(f"{name}: device ms per kernel {per_kernel}", flush=True)
    so = cuda_lib.BUILD / "libxor_gather_clocks.so"
    subprocess.run([nvcc, *cuda_lib.NVCC_FLAGS, "-DXOR_PHASE_CLOCKS", "-o",
                    str(so), str(cuda_lib.CSRC / "xor_gather.cu")], check=True)
    lib = ctypes.CDLL(str(so.resolve()))
    lib.xor_clocks_read.argtypes = [ctypes.c_void_p]
    built = cuda_lib._LIBS.get("xor_gather")
    cuda_lib._LIBS["xor_gather"] = lib
    for name, call in calls.items():
        call()
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * 6)()
        cuda_lib.check(lib.xor_clocks_read(ctypes.addressof(buf)),
                       "xor_clocks_read")
        clocks = dict(zip(("wait", "runs", "issue", "gather", "epilogue",
                           "total"), list(buf)))
        res[name]["sm_clocks"] = clocks
        print(f"{name}: SM clocks of thread 0, CTA (0, 0, 0) {clocks}",
              flush=True)
    cuda_lib._LIBS["xor_gather"] = built
    return res


def phases(groups: tuple) -> dict:
    """This tree's phases. "pir": K3's SM clocks per phase at each case,
    from protocol.cu built with -DK3_PHASE_CLOCKS and called through its C
    entry point; then K5's block setup at each K5 case, from aes_mmo.cu
    built with -DAES_FILL_CLOCKS. "gather": gather_phases."""
    sys.path[:0] = [str(ROOT)]
    import torch

    import chip_smoke as cs
    from pacmann_tpu_torch.ops import aes
    from pacmann_tpu_torch.ops import protocol_kernels as pk
    from pacmann_tpu_torch.utils import cuda_lib

    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    cuda_lib.BUILD.mkdir(parents=True, exist_ok=True)
    res = {}
    if "gather" in groups:
        res.update(gather_phases(cs, nvcc))
        torch.cuda.empty_cache()
    if "pir" not in groups:
        return res
    so = cuda_lib.BUILD / "libprotocol_phases.so"
    subprocess.run([nvcc, *cuda_lib.NVCC_FLAGS, "-DK3_PHASE_CLOCKS", "-o",
                    str(so), str(cuda_lib.CSRC / "protocol.cu")], check=True)
    lib = ctypes.CDLL(str(so.resolve()))
    lib.select_full.argtypes = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 9 + [
        ctypes.c_void_p]
    lib.k3_clocks_read.argtypes = [ctypes.c_void_p]
    windows = 32                        # kClockWindows in protocol.cu
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    _, k5, k3, _ = cases(cs, aes, pk, gen)
    for label, a, kw, (sel_p, qs_p) in k3:
        Q, P = a[7].shape
        S = kw["S"]
        qs = torch.empty((Q, P, S), dtype=torch.int32, device="cuda")
        sel = [torch.empty((Q, P), dtype=dt, device="cuda") for dt in (
            torch.int32, torch.bool, torch.bool, torch.int32, torch.int32,
            torch.int32)]

        def call():
            cuda_lib.check(lib.select_full(
                *(t.data_ptr() for t in a), qs.data_ptr(),
                *(t.data_ptr() for t in sel), P, S, kw["Hp"],
                a[3].shape[1], kw["R"], Q, kw["C"], kw["max_q"], kw["dpp"],
                cuda_lib.stream_ptr(qs.device)), "select_full")
        call()
        cuda_lib.check(lib.k3_clocks_zero(), "k3_clocks_zero")
        call()
        torch.cuda.synchronize()
        cs.check(torch.equal(qs, qs_p) and all(
            torch.equal(x, y) for x, y in zip(sel, sel_p)),
            f"K3 {label} (phase clocks) differs from its plain version")
        buf = (ctypes.c_ulonglong * ((windows + 1) * 6))()
        cuda_lib.check(lib.k3_clocks_read(ctypes.addressof(buf)),
                       "k3_clocks_read")
        marks = [list(buf[6 * w:6 * w + 6]) for w in range(windows + 1)]
        used = [m for m in marks[:windows] if m[0]]
        want = min(windows, -(-Q // pk.SELECT_WINDOW))
        cs.check(len(used) == want and all(all(m) for m in used),
                 f"K3 {label}: marks of {len(used)} windows, not {want}")
        k = marks[windows]
        clocks = dict(init=k[1] - k[0], sync0=k[2] - k[1],
                      **{name: sum(m[i + 1] - m[i] for m in used)
                         for i, name in enumerate(PHASES)},
                      last_sync=k[4] - k[3], total=k[4] - k[0])
        res[label] = clocks
        print(f"K3 phases {label}: SM clocks {clocks}", flush=True)

    so = cuda_lib.BUILD / "libaes_mmo_clocks.so"
    subprocess.run([nvcc, *cuda_lib.NVCC_FLAGS, "-DAES_FILL_CLOCKS", "-o",
                    str(so), str(cuda_lib.CSRC / "aes_mmo.cu")], check=True)
    lib = ctypes.CDLL(str(so.resolve()))
    lib.aes_mmo_points.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int] * 2 + [ctypes.c_uint, ctypes.c_void_p]
    lib.aes_clocks_zero.argtypes = []
    lib.aes_clocks_read.argtypes = [ctypes.c_void_p]
    for label, rk, tags, xs, mask in k5:
        P, L = tags.shape
        out = torch.empty_like(tags)
        words = rk.reshape(P, 44 * 4).view(torch.int32)

        def call():
            cuda_lib.check(lib.aes_mmo_points(
                words.data_ptr(), tags.data_ptr(), xs.data_ptr(),
                out.data_ptr(), P, L, mask, cuda_lib.stream_ptr(out.device)),
                "aes_mmo_points")
        call()
        cuda_lib.check(lib.aes_clocks_zero(), "aes_clocks_zero")
        call()
        torch.cuda.synchronize()
        cs.check(torch.equal(out, aes.prf_eval_plain(rk, tags, xs, mask)),
                 f"K5 {label} (setup clocks) differs from its plain version")
        buf = (ctypes.c_ulonglong * 4)()
        cuda_lib.check(lib.aes_clocks_read(ctypes.addressof(buf)),
                       "aes_clocks_read")
        cs.check(all(buf[k] for k in range(4)), f"K5 {label}: a mark is 0")
        clocks = dict(image=buf[1] - buf[0], fold=buf[2] - buf[1],
                      evals=buf[3] - buf[2], total=buf[3] - buf[0])
        res[f"K5 {label}"] = clocks
        print(f"K5 setup {label}: SM clocks of block (0, 0) {clocks}",
              flush=True)
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--base", type=Path,
                    help="root of the base tree (holds pacmann_tpu_torch)")
    ap.add_argument("--groups", default="pir,gather",
                    help="comma-separated: pir (K1, K3, K4, K5), gather "
                    "(K2, K7a-K7c)")
    ap.add_argument("--phases", action="store_true")
    ap.add_argument("--turn", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--out", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.turn is not None:
        args.out.write_text(json.dumps(turn(args.turn,
                                            tuple(args.groups.split(",")))))
        return 0
    if args.base is None:
        ap.error("--base is required")

    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: CUDA is not available", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT)]
    import chip_smoke as cs

    print(cs.gpu_line())
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    res = {}
    for i, (name, tree) in enumerate((("base", args.base), ("tree", ROOT),
                                      ("tree", ROOT), ("base", args.base))):
        got = out / f"kernel_ab_turn{i}.json"
        subprocess.run([sys.executable, __file__, "--turn", str(tree),
                        "--out", str(got), "--groups", args.groups],
                       check=True)
        for key, value in json.loads(got.read_text()).items():
            res.setdefault(key, {}).setdefault(name, []).append(value)
            print(name, key, value, flush=True)
    if args.phases:
        res["phases"] = phases(tuple(args.groups.split(",")))
    (out / "kernel_ab.json").write_text(json.dumps(res, indent=1))
    for key, v in res.items():
        if key != "phases":
            print(key, json.dumps(v))
    return 0


if __name__ == "__main__":
    sys.exit(main())
