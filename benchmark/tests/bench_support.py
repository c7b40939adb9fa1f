"""Paths and the tiny checkout the benchmark's tests share."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

HARNESS = Path(__file__).resolve().parent.parent
ROOT = HARNESS.parent
for p in (str(HARNESS), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY_N = 8192


def tiny_derived(n: int, batch: int, fail: int) -> dict:
    from pacmann_tpu_torch.pir.params import (derive_batch_params,
                                              derive_piano_params)

    c = derive_batch_params(n, 640, batch, fail)
    p = derive_piano_params(c.partition_size, 640, fail)
    return dict(P=c.partition_num, psize=c.partition_size, C=p.chunk_size,
                S=p.set_size, Hp=p.primary_hint_num,
                R=p.max_query_per_chunk, T=p.total_tags,
                max_query_num=p.max_query_num, k=2)


def make_tiny_root(dest: Path) -> Path:
    """A checkout root holding the benchmark and the tiny cells."""
    shutil.copytree(HARNESS, dest / HARNESS.name,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    h = dest / spec["paths"][0]
    cfg = json.loads((h / "configs" / "sift1m_b32.json").read_text())
    cfg.update(name="tiny", n=TINY_N, starts=64,
               derived=tiny_derived(TINY_N, cfg["batch"],
                                    cfg["failure_prob_log2"]))
    (h / "configs" / "tiny.json").write_text(json.dumps(cfg))
    (h / "traffic" / "g4.json").write_text(json.dumps(dict(
        entry="search", loop="closed", clients=1, group=4, warm_searches=1,
        check_share=0.5, sync_searches=1, trace_searches=1)))
    spec["configs"].append(dict(name="tiny", source="a test",
                                file=f"{spec['paths'][0]}/configs/tiny.json",
                                reduced=["n"], why="a test"))
    tiny = [f"tiny.{t}" for t in ("g1", "g4", "prep")]
    spec["workloads"] += [dict(name=w, config="tiny",
                               traffic=w.split(".")[1], chips=1, why="test")
                          for w in tiny]
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] = m["workloads"] + tiny
    (dest / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return dest
