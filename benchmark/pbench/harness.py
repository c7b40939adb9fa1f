"""One run of one cell: set-up, the measured window, the traced extras,
the check, and the result line.

  set-up   the deployment's rows made on the card from the seed and handed
           to the engine, which packs them (the rows are then freed); the
           kernels the program builds on first use, loaded; the entry's
           warm-up; setup_s runs from the process's start to here;
  window   the traffic mix's requests, back to back, for --seconds;
  trace    (--trace 1) counts, an unprofiled and a profiled pass over the
           same requests, and each per-layer metric's reader;
  check    the program's state freed, the reference over the requests
           held from the window; each number beside its limit.

The mix names its entry, entries/<entry>.py (pbench/spec.py::entry).

peak_mem_gb is torch.cuda.max_memory_allocated from the hand-over of the
rows to the end of the window: the rows the engine is given, its pack
beside them, its state, warm-up and the window; the making of the rows,
the benchmark's own work, is left out (pbench/cell.py::build_engine).
memory_peak_bytes covers the whole process up to the window's end.
"""

from __future__ import annotations

import gc
import subprocess
import time
from pathlib import Path

import torch

from pbench import spec as specmod

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "pacmann_tpu"})


class NoDevice(RuntimeError):
    pass


def forbidden_modules(modules) -> list[str]:
    """The loaded modules whose top-level name, compared whole, is jax's,
    flax's or the JAX package's."""
    return sorted({m.split(".")[0] for m in modules} & FORBIDDEN)


def _peak(dev: torch.device) -> int:
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def device_block(dev: torch.device, chips: int, peak: int) -> dict:
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": peak}
    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
           "count": chips, "memory_peak_bytes": peak}
    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True)
        out["power_limit"] = proc.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        pass
    return out


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             trace: bool, *, device: str = "cuda", control: bool = False,
             t_start: float | None = None) -> dict:
    """Run a cell once. -> the result line's object (its last key,
    "checks", holds each number compared with its limit)."""
    t_start = time.perf_counter() if t_start is None else t_start
    root = Path(root)
    spec = specmod.load(root)
    wl = specmod.workload(spec, workload)
    cfg = specmod.config(root, spec, wl["config"])
    mix = specmod.traffic(root, spec, wl["traffic"])
    dev = torch.device(device)
    if dev.type == "cuda" and (not torch.cuda.is_available()
                               or torch.cuda.device_count() < wl["chips"]):
        raise NoDevice(f"{workload} needs {wl['chips']} CUDA device(s)")
    entry = specmod.entry(root, spec, mix["entry"])
    cell = entry(cfg, mix, seed, dev, control=control)

    t_build = time.perf_counter()
    cell.build()
    _sync(dev)
    t_warm = time.perf_counter()
    cell.warm()
    _sync(dev)
    setup_s = time.perf_counter() - t_start
    parts = dict(start_s=t_build - t_start, **cell.setup_parts,
                 build_s=t_warm - t_build,
                 warm_s=t_start + setup_s - t_warm)

    gc.collect()
    win = cell.window(seconds)
    _sync(dev)
    held_peak = _peak(dev)
    peak = max(cell.rows_peak, held_peak)

    metrics, extra = {}, {}
    if not trace:
        values = dict(cell.end_to_end(win), setup_s=setup_s)
        if dev.type == "cuda":
            values["peak_mem_gb"] = held_peak / 1e9
        for m in spec["end_to_end"]:
            # "prep_ms.sift1m" is the entry's prep_ms, under a name (and a
            # bound) of its own in the cells its `workloads` lists
            name = m["name"]
            value = values.get(name, values.get(name.split(".")[0]))
            if specmod.applies(m, workload) and value is not None:
                metrics[name] = {"value": value, "unit": m["unit"]}
    else:
        ctx = cell.traced(win)
        for m in spec["per_layer"]:
            if specmod.applies(m, workload):
                v = specmod.reader(root, spec, m["name"])(ctx)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        if ctx.trace.device:
            extra["device"] = {"busy_s": ctx.trace.busy_s(),
                               "window_s": ctx.trace.window_s()}
        extra["breakdown"] = ctx.trace.breakdown()
        del ctx

    cell.release()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks, failed = cell.check()
    out = {"correct": all(v <= lim for _, v, lim in checks),
           "attempted": win["attempted"],
           "failed": failed, "metrics": metrics,
           "device": dict(device_block(dev, wl["chips"], peak),
                          **extra.get("device", {}))}
    if "breakdown" in extra:
        out["breakdown"] = extra["breakdown"]
    out["setup_parts"] = parts
    if "sample_cost" in win:
        out["sample_cost"] = win["sample_cost"]
    out["checks"] = {name: {"value": v, "limit": lim}
                     for name, v, lim in checks}
    return out


def check_lines(result: dict) -> list[str]:
    return [f"{name}: {c['value']} (limit {c['limit']})"
            for name, c in result["checks"].items()]
