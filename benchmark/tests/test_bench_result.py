"""The result line and the command's behaviour without a card."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys

import pytest
from bench_support import HARNESS, ROOT

from pbench import harness

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("traced", (False, True))
def test_result_has_the_keys_and_checks_last(tiny_root, traced):
    res = harness.run_cell(tiny_root, "tiny.g1", 3, 0.2, traced,
                           device="cpu")
    keys = list(res)
    assert keys[:5] == KEYS and keys[-1] == "checks"
    assert set(keys) == set(KEYS) | {"setup_parts", "sample_cost",
                                     "checks"} | (
        {"breakdown"} if traced else set())
    if traced:
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        assert all(len(v) <= 10 for v in res["breakdown"].values())
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"}
    d = res["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(d)
    json.dumps(res)
    lines = harness.check_lines(res)
    assert len(lines) == len(res["checks"]) and "(limit " in lines[0]


def test_untraced_metrics_are_the_cells_end_to_end(tiny_root):
    res = harness.run_cell(tiny_root, "tiny.prep", 3, 0.2, False,
                           device="cpu")
    # on the CPU: no peak_mem_gb, which only the card measures
    assert set(res["metrics"]) == {"prep_ms.sift100m", "prep_ms.sift1m",
                                   "setup_s"}
    assert all(v["value"] > 0 for v in res["metrics"].values())


def test_no_result_without_a_card():
    if __import__("torch").cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run(
        [sys.executable, str(HARNESS / "run.py"), "--workload", "sift1m.g1",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_no_result_beside_only_the_benchmark(tmp_path):
    """In a directory holding only BENCHMARK.json and the benchmark's
    paths, the port cannot be imported: no result, a nonzero exit."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HARNESS, tmp_path / HARNESS.name,
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, str(tmp_path / HARNESS.name / "run.py"),
         "--workload", "sift1m.g1", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=120, env={"PATH": "/usr/bin:/bin"})
    assert proc.returncode != 0 and proc.stdout.strip() == ""
