"""Nothing the benchmark loads has the top-level name jax, jaxlib, flax or
pacmann_tpu (the JAX package), names compared whole: the port's name,
pacmann_tpu_torch, begins with the JAX package's."""

from __future__ import annotations

import json
import subprocess
import sys

from bench_support import HARNESS, ROOT, make_tiny_root

from pbench import harness

DRIVE = """
import json, sys
from pathlib import Path
sys.path[:0] = [{harness!r}, {root!r}]
from bench_support import make_tiny_root
from pbench import harness, spec
import reference.aes, reference.prep, reference.search
root = make_tiny_root(Path({tmp!r}))
s = spec.load(root)
for m in s["per_layer"]:
    spec.reader(root, s, m["name"])
for cell, traced in (("tiny.g4", True), ("tiny.prep", True)):
    assert harness.run_cell(root, cell, 9, 0.2, traced,
                            device="cpu")["correct"]
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_whole_names_are_compared():
    assert harness.forbidden_modules(
        ["pacmann_tpu_torch", "pacmann_tpu_torch.pir", "jaxtyping",
         "flaxen"]) == []
    assert harness.forbidden_modules(
        ["pacmann_tpu.pir", "jax", "jaxlib.xla_client", "flax"]) == \
        ["flax", "jax", "jaxlib", "pacmann_tpu"]


def test_a_run_loads_no_jax_module(tmp_path):
    code = DRIVE.format(harness=str(HARNESS), root=str(ROOT),
                        tmp=str(tmp_path))
    code = code.replace("from bench_support",
                        "sys.path.insert(0, %r)\nfrom bench_support"
                        % str(HARNESS / "tests"))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    loaded = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "pacmann_tpu_torch" in loaded and "pbench" in loaded
    assert harness.forbidden_modules(loaded) == []


def test_tiny_root_is_built_from_new_files_only(tmp_path):
    root = make_tiny_root(tmp_path)
    original = json.loads((ROOT / "BENCHMARK.json").read_text())
    tiny = json.loads((root / "BENCHMARK.json").read_text())
    for key in ("configs", "workloads"):
        assert tiny[key][:len(original[key])] == original[key]
    for rel in ("configs/sift1m_b32.json", "traffic/g1.json",
                "metrics/k2_roofline.sift1m.py"):
        assert (root / HARNESS.name / rel).read_bytes() == \
            (HARNESS / rel).read_bytes()
