"""The port's 1M graph build over several seeds, on the card: the spread
of its quality on chip_smoke.py's manifold workloads.

For each latent dimensionality and seed: N = 1M u8 manifold vectors of
that many latent dimensions and 1,000 queries (chip_smoke.manifold_vectors,
data from np.random.default_rng(seed)), graph/build.py::build_graph with
its defaults (m = 32, rounds 6, keep_nearest 16, corridor 16:2:1) and the
gate on at that seed; then chip_smoke's built_graph_phase (plaintext
recall@10, step 20, parallel 3, against a random graph's) and
cluster_phase (1,000 clusters, 10 iterations). One JSON line a build, and
all of them in chiprun_out/build_quality.json. chip_smoke.py's
latent-12 bars come from these readings.

    python3 scripts/build_quality.py --latent 12 --seeds 5 6 7 8
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--latent", type=int, nargs="+", default=[12])
    ap.add_argument("--seeds", type=int, nargs="+", default=[5, 6, 7, 8])
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from pacmann_tpu_torch.graph import build

    rows = []
    for latent in args.latent:
        for seed in args.seeds:
            rng = np.random.default_rng(seed)
            basis = rng.standard_normal((latent, cs.DIM), dtype=np.float32)
            v = cs.manifold_vectors(rng, basis, cs.N)
            q = cs.manifold_vectors(rng, basis, cs.L2_Q).astype(np.float32)
            stats = {}
            graph = build.build_graph(v, cs.M, seed=seed, quality_gate=True,
                                      stats=stats)
            cs.graph_invariants(graph, cs.N, f"latent {latent} seed {seed}")
            vt = torch.from_numpy(v).cuda().float()
            built, gnd = cs.built_graph_phase(vt, q, graph, seed)
            clus = cs.cluster_phase(vt, q, gnd, seed)
            row = dict(latent=latent, seed=seed, n=cs.N, m=cs.M,
                       build_s=stats["seconds"],
                       draw_seconds=stats["draw_seconds"],
                       peak_gb=stats["peak_gb"], phases=stats["phases"],
                       gate_hit_rate=stats["gate"][0],
                       gate_avg_steps=stats["gate"][1],
                       recall=built["built"], random_recall=built["random"],
                       cluster_recall=clus["recall"],
                       cluster_train_s=clus["train_s"])
            print(json.dumps(row), flush=True)
            rows.append(row)
            del vt, gnd, graph
            torch.cuda.empty_cache()
    for latent in args.latent:
        mine = [r for r in rows if r["latent"] == latent]
        print(f"latent {latent}: gate {min(r['gate_hit_rate'] for r in mine)}"
              f"-{max(r['gate_hit_rate'] for r in mine)}, recall@10 "
              f"{min(r['recall'] for r in mine)}-"
              f"{max(r['recall'] for r in mine)} over seeds {args.seeds}")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "build_quality.json").write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
