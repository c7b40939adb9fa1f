"""Full private-search quality at scale (the canonical n = 1e6 demo): the
port's twin of the JAX package's scripts/e2e_scale.py, with its flags and
phases, plus --device.

Builds (or loads) the graph over synthetic vectors, then measures recall@k
of (a) the plaintext beam engine and (b) the fused private search against
brute-force ground truth, at the reference's canonical configuration
(k = 10, step = 20, parallel = 3, FailureProbLog2 = 8;
run-private-search.sh:16-18, private-search-report.txt).

Usage:
  python -m pacmann_tpu_torch.scripts.e2e_scale [--n 1000000] [--rounds 8]
      [--queries 100] [--uniform | --continuum [--device-synth]]
      [--latent 16] [--keep 16] [--corridor 16:2[:1]] [--rebuild]
      [--build-only] [--device cuda|cpu] [--out DIR]

Writes phase timings to stdout and a JSON report to
reports/torch/e2e_{tag}_report.json (--out: another directory); the graph
is cached as graph_torch_{tag}.npy in the temporary directory.
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from pacmann_tpu_torch.scripts import REPORTS, device_line, peak_gib, sync
from pacmann_tpu_torch.utils import cuda_lib


def synth_continuum(n: int, d: int, rng, latent: int = 16) -> np.ndarray:
    """Continuum latent-manifold data: points ON a latent-dim Gaussian
    manifold embedded in d dims (plus small ambient noise), with NO
    mixture structure. k-means cells become an arbitrary Voronoi
    tessellation of a continuum, so a query's true neighbors straddle
    cell boundaries and the nearest-centroid (Tiptoe-style) baseline
    collapses (the regime real SIFT shows: cluster recall 0.391 in the
    reference's cluster-report.txt:3) while graph search still navigates
    (low intrinsic dimension). The same draws as the JAX package's
    synth_continuum from the same generator."""
    basis = (rng.standard_normal((latent, d)) / np.sqrt(latent)) \
        .astype(np.float32)
    out = np.empty((n, d), np.float32)
    block = 1 << 16
    for b0 in range(0, n, block):
        b = min(block, n - b0)
        z = rng.standard_normal((b, latent)).astype(np.float32)
        out[b0:b0 + b] = (z @ basis
                          + 0.02 * rng.standard_normal((b, d)).astype(
                              np.float32))
    return out


def synth_continuum_device(n: int, d: int, seed: int, latent: int = 16,
                           device=None) -> torch.Tensor:
    """Device-side twin of synth_continuum: the data never exists on the
    host, so no (n, d) upload. Returns an (n, d) f32 tensor on `device`
    (None: the card) drawn from a torch.Generator seeded with `seed`: a
    different stream from the host version's and from the JAX package's
    jax.random one, hence the "dev" tag."""
    dev = cuda_lib.default_device(None, device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    basis = torch.randn((latent, d), generator=gen, device=dev) \
        / float(np.sqrt(latent))
    z = torch.randn((n, latent), generator=gen, device=dev)
    noise = torch.randn((n, d), generator=gen, device=dev)
    with cuda_lib.fp32_matmul(dev):
        return z @ basis + 0.02 * noise


def synth_vectors(n: int, d: int, clustered: bool, rng,
                  latent: int = 16, spread: float = 0.35) -> np.ndarray:
    """SIFT-like synthetic data (or uniform with clustered=False), the
    same draws as the JAX package's synth_vectors from the same generator.

    Clustered mode: a mixture of Gaussians whose centers live in a
    `latent`-dimensional random subspace. Real descriptor data (SIFT
    intrinsic dimension ~12-16) is navigable because inter-cluster
    distances vary. Centers drawn i.i.d. in the full d = 128 are all
    equidistant (distance concentration), which is adversarial for any
    graph-ANN method; latent=0 keeps that variant."""
    if not clustered:
        return rng.random((n, d), dtype=np.float32)
    n_c = max(256, int(np.sqrt(n)) // 4)  # 1M -> 250 -> 256; 65k -> 256
    n_c = 1 << int(np.ceil(np.log2(n_c)) + 2)  # 1M -> 1024
    if latent and latent < d:
        u = rng.standard_normal((n_c, latent)).astype(np.float32)
        basis = (rng.standard_normal((latent, d)) / np.sqrt(latent)) \
            .astype(np.float32)
        centers = u @ basis
    else:
        centers = rng.standard_normal((n_c, d)).astype(np.float32)
    out = np.empty((n, d), np.float32)
    block = 1 << 16
    for b0 in range(0, n, block):
        b = min(block, n - b0)
        lab = rng.integers(0, n_c, b)
        out[b0:b0 + b] = (centers[lab]
                          + spread * rng.standard_normal((b, d)).astype(
                              np.float32))
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="e2e_scale",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--random-starts", action="store_true",
                    help="reference-style random sqrt(n) starts instead of "
                         "the centroid start selection")
    ap.add_argument("--queries", type=int, default=100)
    ap.add_argument("--uniform", action="store_true")
    ap.add_argument("--continuum", action="store_true",
                    help="latent-manifold continuum data (the graph-vs-"
                         "cluster separation workload)")
    ap.add_argument("--device-synth", action="store_true",
                    help="synthesize the continuum data on the device and "
                         "keep the whole data path there")
    ap.add_argument("--latent", type=int, default=16,
                    help="intrinsic dim of cluster centers (0 = full-d "
                         "equidistant centers, the adversarial variant)")
    ap.add_argument("--keep", type=int, default=16,
                    help="keep_nearest harvest slots in the final prunes")
    ap.add_argument("--corridor", type=str, default="16:2",
                    help="corridor beam budget max_step:parallel[:passes]")
    ap.add_argument("--rebuild", action="store_true")
    ap.add_argument("--build-only", action="store_true")
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--step", type=int, default=20)
    ap.add_argument("--parallel", type=int, default=3)
    ap.add_argument("--device", default=None,
                    help="torch device of every phase (default: the card)")
    ap.add_argument("--out", default=str(REPORTS),
                    help="directory of the JSON report")
    return ap


def corridor_recipe(corridor: str) -> tuple[int, int, int]:
    """"step:par[:passes]" -> (corridor_step, corridor_par, passes)."""
    cf = [int(x) for x in corridor.split(":")]
    return cf[0], cf[1], (cf[2] if len(cf) > 2 else 1)


def data_tag(args) -> str:
    """The JAX script's tag of a run's data and build recipe."""
    cs, cp, cn = corridor_recipe(args.corridor)
    tag = (f"{args.n}_uniform" if args.uniform
           else f"{args.n}_continuum_l{args.latent}dev" if args.continuum
           and args.device_synth
           else f"{args.n}_continuum_l{args.latent}" if args.continuum
           else f"{args.n}_clustered_l{args.latent}")
    if (args.keep, cs, cp, cn) != (16, 16, 2, 1):  # recipe-bearing tag
        tag += f"_k{args.keep}c{cs}x{cp}x{cn}"
    return tag


def main(argv=None) -> dict:
    """Run the demo; returns the report (also written as JSON)."""
    args = build_parser().parse_args(argv)
    dev = cuda_lib.default_device(None, args.device)
    n, d, m = args.n, 128, 32
    cs, cp, cn = corridor_recipe(args.corridor)
    tag = data_tag(args)
    gpath = Path(tempfile.gettempdir()) / f"graph_torch_{tag}.npy"
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    report_path = out_dir / f"e2e_{tag}_report.json"
    report = {"n": n, "d": d, "m": m, "rounds": args.rounds,
              "keep_nearest": args.keep, "corridor": args.corridor,
              "clustered": not args.uniform, "continuum": args.continuum,
              "latent": args.latent, "k": args.k, "step": args.step,
              "parallel": args.parallel, "device": str(dev),
              "gpu": device_line(dev) if dev.type == "cuda" else None}
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    def write():
        report_path.write_text(json.dumps(report, indent=1))

    rng = np.random.default_rng(0)
    t0 = time.time()
    if args.continuum and args.device_synth:
        vectors = synth_continuum_device(n, d, seed=0, latent=args.latent,
                                         device=dev)
        sync(dev)
    elif args.continuum:
        vectors = synth_continuum(n, d, rng, latent=args.latent)
    else:
        vectors = synth_vectors(n, d, not args.uniform, rng,
                                latent=args.latent)
    print(f"vectors synthesized: {time.time() - t0:.1f}s", flush=True)

    from pacmann_tpu_torch.graph.build import build_graph

    if gpath.exists() and not args.rebuild:
        graph = np.load(gpath).astype(np.int64)
        print("graph loaded", flush=True)
    else:
        t0 = time.time()
        graph = np.asarray(build_graph(vectors, m, rounds=args.rounds,
                                       seed=0, verbose=True,
                                       keep_nearest=args.keep,
                                       corridor_step=cs, corridor_par=cp,
                                       corridor_passes=cn, device=dev),
                           np.int64)
        build_s = time.time() - t0
        report["build_s"] = round(build_s, 2)
        report["peak_build_gib"] = peak_gib(dev)
        print(f"graph built: {build_s:.1f}s", flush=True)
        np.save(gpath, graph.astype(np.int32))
        # interim dump: a long big-n run leaves the build record even if a
        # later phase dies
        write()
    if args.build_only:
        write()
        print("DONE (build only)", flush=True)
        return report

    from pacmann_tpu_torch.graph.recall import brute_force_knn, compute_recall

    Q = args.queries
    if args.uniform:
        queries = rng.random((Q, d), dtype=np.float32)
    else:
        pick = rng.choice(n, Q, replace=False)
        # a gather of Q rows, then a (Q, d) copy to the host
        rows = vectors[torch.as_tensor(pick, device=dev)].cpu().numpy() \
            if isinstance(vectors, torch.Tensor) else vectors[pick]
        queries = rows + 0.1 * rng.standard_normal((Q, d)).astype(np.float32)
    t0 = time.time()
    gnd = brute_force_knn(vectors, queries, args.k, device=dev)
    print(f"ground truth: {time.time() - t0:.1f}s", flush=True)

    from pacmann_tpu_torch.graph.beam import PlaintextEngine
    from pacmann_tpu_torch.graph.build import choose_start_ids

    if args.random_starts:
        sids = rng.choice(n, int(np.sqrt(n)), replace=False)
    else:
        t0 = time.time()
        sids = choose_start_ids(vectors, int(np.sqrt(n)), seed=0, device=dev)
        print(f"centroid starts: {time.time() - t0:.1f}s", flush=True)
    eng = PlaintextEngine(vectors, graph, start_ids=sids, device=dev)
    t0 = time.time()
    ids, _ = eng.search(queries, args.k, args.step, args.parallel, seed=1)
    r_plain = compute_recall(gnd, ids, args.k)
    report["plaintext_recall"] = round(r_plain, 4)
    print(f"plaintext recall@{args.k}: {r_plain:.4f} "
          f"({time.time() - t0:.1f}s incl. the first call)", flush=True)

    from pacmann_tpu_torch.pir.device_engine import DevicePianoEngine
    from pacmann_tpu_torch.private.fused_search import FusedPrivateSearch
    from pacmann_tpu_torch.private.oracle import (
        pack_vertex_db,
        pack_vertex_db_device,
    )

    if args.device_synth:
        # no host round trip: the entries are packed where the vectors are
        raw = pack_vertex_db_device(vectors, torch.as_tensor(graph,
                                                             device=dev))
    else:
        raw = pack_vertex_db(vectors, graph)
    engine = DevicePianoEngine(n, 4 * (d + m), m, raw, 8, device=dev)
    del raw
    t0 = time.time()
    engine.preprocessing(rng=np.random.default_rng(1))
    prep_s = time.time() - t0
    report["prep_s"] = round(prep_s, 4)
    print(f"prep: {prep_s:.4f}s (incl. the first call)", flush=True)

    start_vecs = vectors[torch.as_tensor(sids, device=dev)].cpu().numpy() \
        if isinstance(vectors, torch.Tensor) else vectors[sids]
    fs = FusedPrivateSearch(engine, sids, start_vecs, graph[sids], dim=d,
                            m=m, n=n)
    # group-16 fused calls; the segmented path refreshes hints mid-group
    # whenever the budget window is short, so any group size works
    B = 16

    def search(qb, seed):
        fs.generator.manual_seed(seed)
        return fs.search(qb, k=args.k, max_step=args.step,
                         parallel=args.parallel)

    t0 = time.time()
    search(queries[:B], 2)
    sync(dev)
    print(f"fused first call: {time.time() - t0:.1f}s", flush=True)
    out = np.zeros((Q, args.k), np.int64)
    t0 = time.time()
    for i in range(0, Q, B):
        j = min(i + B, Q)
        qb = queries[i:j]
        if len(qb) < B:
            qb = np.concatenate([qb, np.tile(qb[-1:], (B - len(qb), 1))])
        out[i:j] = search(qb, 3 + i)[: j - i]
    sync(dev)
    dt = time.time() - t0
    r_priv = compute_recall(gnd, out, args.k)
    report["private_recall"] = round(r_priv, 4)
    report["private_ms_per_query"] = round(dt / Q * 1000, 3)
    report["peak_gib"] = peak_gib(dev)
    print(f"fused private: {dt / Q * 1000:.1f} ms/query, "
          f"recall@{args.k}: {r_priv:.4f}", flush=True)

    write()
    print(f"report -> {report_path}", flush=True)
    print("DONE", flush=True)
    return report


if __name__ == "__main__":
    main()
