"""SIFT100M deployment plan: the port's twin of the JAX package's
scripts/plan_100m.py. Derives the tier's PIR parameters, counts the bytes
each card holds in the port's own state dtypes, checks that they fit the
card's memory, and runs a miniature 8-shard prep and query with the same
entry shape to show the sharded path executes (reference config:
run-private-search.sh:21, n = 1e8, d = 128, m = 32, step = 32,
parallel = 4; batch 32 -> 16 partitions, 8 shards of 2).

Usage: python -m pacmann_tpu_torch.scripts.plan_100m [--device cuda|cpu]
           [--out DIR]
The mini run's mesh is the device repeated 8 times (logical shards on one
card, or on the CPU). Writes reports/torch/sift100m_plan.json (--out:
another directory).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from pacmann_tpu_torch.pir import layout
from pacmann_tpu_torch.pir.params import derive_batch_params, derive_piano_params
from pacmann_tpu_torch.scripts import REPORTS, device_line
from pacmann_tpu_torch.utils import cuda_lib

N = 100_000_000
D, M = 128, 32
ENTRY = 4 * (D + M)          # 640 B
BATCH = 32                   # -> 16 partitions (batch-pir.go:62-64)
FAIL_LOG2 = 8
N_CARDS = 8
# the card the plan is sized for where none is present to ask
NAMED_CARD = "NVIDIA H100 80GB HBM3"
NAMED_CARD_BYTES = 80 << 30
HEADROOM = 1 << 30           # transients: the AES state, a batch's buffers
MINI_N = 131_072


def gib(x) -> float:
    return round(x / (1 << 30), 3)


def derive(n: int):
    """The deployment's batch and per-partition parameters at n entries."""
    c = derive_batch_params(n, ENTRY, BATCH, FAIL_LOG2)
    return c, derive_piano_params(c.partition_size, ENTRY, FAIL_LOG2)


def partition_bytes(p, k: int) -> dict:
    """Device bytes of one partition of DevicePianoEngine's DB and state,
    every state tensor int32 (the PRF table and the slot columns too,
    where the JAX engine narrows them to u16)."""
    S, C, Hp, R = (p.set_size, p.chunk_size, p.primary_hint_num,
                   p.max_query_per_chunk)
    T, Ep = Hp + S * R, k * 128
    return {"db_shard": S * C * Ep * 4,
            "parities": T * Ep * 4,
            "prf_table_i32": T * S * 4,
            "slot_col_i32": S * Hp * 4,
            "repl_val": S * R * Ep * 4,
            "repl_idx": S * R * 4,
            "tag_prog": 2 * Hp * 4,
            "hist_finished": (S + 1) * 4}


def card_memory(dev: torch.device) -> tuple[str, int]:
    """(name, bytes) of the card the plan must fit: the device's own where
    it is a card, else the named H100's 80 GiB."""
    if dev.type == "cuda":
        props = torch.cuda.get_device_properties(dev)
        return props.name, props.total_memory
    return f"{NAMED_CARD} (named; no card present)", NAMED_CARD_BYTES


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="plan_100m",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device of the mini run (default: the card)")
    ap.add_argument("--out", default=str(REPORTS),
                    help="directory of sift100m_plan.json")
    return ap


def main(argv=None) -> dict:
    """Print and write the plan; returns it."""
    args = build_parser().parse_args(argv)
    dev = cuda_lib.default_device(None, args.device)
    c, p = derive(N)
    k = layout.entry_rows(ENTRY // 4)
    P = c.partition_num
    per_card_parts = P // N_CARDS
    per_card = {key: v * per_card_parts
                for key, v in partition_bytes(p, k).items()}
    total = sum(per_card.values())
    card, card_bytes = card_memory(dev)
    S, Hp = p.set_size, p.primary_hint_num
    plan = {
        "config": {"n": N, "d": D, "m": M, "entry_bytes": ENTRY,
                   "batch": BATCH, "partitions": P, "cards": N_CARDS,
                   "partitions_per_card": per_card_parts},
        "derived": {"partition_size": c.partition_size,
                    "chunk_size": p.chunk_size, "set_size": S,
                    "primary_hint_num": Hp,
                    "max_query_num": p.max_query_num,
                    "max_query_per_chunk": p.max_query_per_chunk,
                    "total_tags": p.total_tags, "entry_rows": k},
        "per_card_bytes": per_card,
        "per_card_gib": {key: gib(v) for key, v in per_card.items()},
        "per_card_total_gib": gib(total),
        "card": card,
        "card_memory_gib": gib(card_bytes),
        "fits": bool(total < card_bytes - HEADROOM),
        "client_extra_state_gib": gib((p.total_tags * S + S * Hp) * 4 * P),
        "client_reference_model_gib": gib(p.local_storage_bytes() * P),
    }
    print(json.dumps(plan, indent=1), flush=True)
    if not plan["fits"]:
        raise RuntimeError(f"the per-card budget, {gib(total)} GiB, does "
                           f"not fit {card}'s {gib(card_bytes)} GiB")

    # ---- miniature 8-shard prep+query, same entry shape (640 B, k = 2)
    from pacmann_tpu_torch.parallel.sharding import make_mesh
    from pacmann_tpu_torch.pir.sharded_engine import ShardedPianoEngine

    rng = np.random.default_rng(3)
    raw = rng.integers(0, 2**32, size=(MINI_N, ENTRY // 4), dtype=np.uint32)
    mesh = make_mesh(devices=[dev] * N_CARDS)
    eng = ShardedPianoEngine(MINI_N, ENTRY, BATCH, raw, FAIL_LOG2, mesh)
    eng.preprocessing(rng=np.random.default_rng(4))
    ids = [int(i * eng.config.partition_size + 7)
           for i in range(eng.config.partition_num)] * 2
    out = eng.query(ids)
    ok = sum(np.array_equal(out[r], raw[i]) for r, i in enumerate(ids))
    print(f"mini 8-shard prep+query ({mesh.describe()}): {ok}/{len(ids)} "
          "exact", flush=True)
    if ok < len(ids) - 2:
        raise RuntimeError(f"mini run: {ok}/{len(ids)} exact")
    plan["mini_run"] = {"n": MINI_N, "exact": int(ok), "total": len(ids),
                        "mesh": mesh.describe(), "device": device_line(dev)}

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    out_path = out_dir / "sift100m_plan.json"
    out_path.write_text(json.dumps(plan, indent=1))
    print(f"plan -> {out_path}", flush=True)
    return plan


if __name__ == "__main__":
    main()
