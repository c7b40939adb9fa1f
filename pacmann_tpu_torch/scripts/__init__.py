"""The scale scripts of the port, twins of the JAX package's scripts/
(e2e_scale, baselines_scale, plan_100m): run each as
`python -m pacmann_tpu_torch.scripts.<name>`. Their reports go to
reports/torch/ and name the device they ran on (device_line)."""

from __future__ import annotations

import platform
import subprocess
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent.parent
REPORTS = REPO / "reports" / "torch"


def cpu_model() -> str:
    """The host CPU's model from /proc/cpuinfo: its model name, else (a
    host that reports none, or "unknown") its vendor, family, model and
    stepping numbers, else the machine's architecture."""
    fields = {}
    try:
        for line in Path("/proc/cpuinfo").read_text().splitlines():
            key, _, value = line.partition(":")
            fields.setdefault(key.strip(), value.strip())
    except OSError:
        pass
    name = fields.get("model name", "")
    if name and name.lower() != "unknown":
        return name
    ids = [f"{key} {fields[key]}" for key in
           ("vendor_id", "cpu family", "model", "stepping",
            "CPU implementer", "CPU part") if fields.get(key)]
    return ", ".join(ids) if ids else (platform.machine() or "unknown CPU")


def device_line(device: torch.device) -> str:
    """What ran the work: a card's name and power limit as `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` gives them, or the
    CPU's model name."""
    if device.type != "cuda":
        return f"CPU ({cpu_model()})"
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    proc = subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return proc.stdout.strip().splitlines()[0]


def peak_gib(device: torch.device):
    """Peak device memory since the last reset, in GiB (None off CUDA)."""
    if device.type != "cuda":
        return None
    return round(torch.cuda.max_memory_allocated(device) / 2**30, 3)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
