"""Exact-search baseline — the quality upper bound (recall 1.0 by
construction), the role the NGT search program plays in the
reference (ngt-search/ngt-search.go, C15); the port of the JAX
package's cli/exact_search.py. One device: the distances go through
l2_distance (kernel K6 on CUDA) and the top-k stays on the device
(graph/recall.py::knn_search). -shards N shards the DB rows over a mesh
of N shards (parallel/sharding.py::sharded_l2_topk: one K6 launch a
shard, a local top-k, a global merge); the shards differ by at most one
row, so no padding row exists to be ranked (the JAX CLI pads with +inf
rows, which win its top-k as NaN distances when N does not divide n)."""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from pacmann_tpu_torch.graph.recall import compute_recall, knn_search
from pacmann_tpu_torch.io.loaders import load_float32_matrix, load_int_matrix
from pacmann_tpu_torch.parallel.sharding import (
    make_mesh, replicate, shard_rows, sharded_l2_topk)
from pacmann_tpu_torch.utils import cuda_lib


def main(argv=None, device=None, devices=None) -> int:
    """device: where the scan runs (a Python keyword, not a flag); None
    means CUDA, which raises where CUDA is not available. devices: the
    mesh of -shards N, N devices (repeats allowed); None means N times
    `device` where it is given, else the CUDA devices round-robin
    (make_mesh)."""
    p = argparse.ArgumentParser(prog="pacmann-exact-search")
    p.add_argument("-n", type=int, default=100000)
    p.add_argument("-d", "--dim", type=int, default=128)
    p.add_argument("-k", type=int, default=10)
    p.add_argument("-q", type=int, default=100)
    p.add_argument("-input", default="")
    p.add_argument("-query", default="")
    p.add_argument("-gnd", default="")
    p.add_argument("-shards", type=int, default=1,
                   help=">1: shard DB rows over a device mesh")
    p.add_argument("-seed", type=int, default=0)
    args = p.parse_args(argv)
    mesh = None
    if args.shards > 1:
        if devices is None and device is not None:
            devices = [device] * args.shards
        mesh = make_mesh(args.shards, devices=devices)
        dev = mesh.devices[0]
    else:
        dev = cuda_lib.default_device(None, device)

    rng = np.random.default_rng(args.seed)
    if args.input:
        vectors = load_float32_matrix(args.input, args.n, args.dim)
    else:
        vectors = rng.random((args.n, args.dim), dtype=np.float32)
    if args.query:
        queries = load_float32_matrix(args.query, args.q, args.dim)
    else:
        queries = rng.random((args.q, args.dim), dtype=np.float32)

    if mesh is None:
        v_dev = torch.as_tensor(vectors, device=dev)
        q_dev = torch.as_tensor(queries, device=dev)
        where = ""

        def scan():
            return knn_search(v_dev, q_dev, args.k)[1].cpu().numpy()
    else:
        v_shards = shard_rows(mesh, torch.as_tensor(vectors))
        q_rep = replicate(mesh, torch.as_tensor(queries))
        where = f" over {mesh.describe()}"

        def scan():
            return sharded_l2_topk(mesh, q_rep, v_shards,
                                   args.k)[0].cpu().numpy()

    scan()                          # warm: kernel build, allocator
    t0 = time.perf_counter()
    ids = scan()                    # ends in a copy to the host
    dt = time.perf_counter() - t0

    print(f"Exact scan: {dt/max(args.q,1)*1000:.3f} ms/query "
          f"({args.n * args.q / max(dt, 1e-9) / 1e9:.2f} G dist/s){where}")
    if args.gnd:
        gnd = load_int_matrix(args.gnd, args.q, args.k)
        print(f"Recall@{args.k}: {compute_recall(gnd, ids, args.k):.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
