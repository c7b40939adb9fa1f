"""On the card (marked `card`; skips without a CUDA device): a short run
of a cell proves correct, and its control does not."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
from bench_support import HARNESS, ROOT

pytestmark = pytest.mark.card


def last_json(cmd):
    proc = subprocess.run([sys.executable, *cmd], cwd=ROOT,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return [json.loads(x) for x in proc.stdout.strip().splitlines()
            if x.startswith("{")]


@pytest.mark.parametrize("cell", ("sift1m.g1", "sift1m.prep"))
def test_short_run_is_correct(card, cell):
    res = last_json([str(HARNESS / "run.py"), "--workload", cell,
                     "--seed", str(2**31 + 77), "--seconds", "2",
                     "--trace", "0"])[-1]
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"


@pytest.mark.parametrize("cell", ("sift1m.g1", "sift1m.prep"))
def test_control_is_not_correct_on_the_card(card, cell):
    out = last_json([str(HARNESS / "readings.py"), "--workload", cell,
                     "--seed", str(2**31 + 78), "--seconds", "3",
                     "--control"])
    assert out and not any(r["correct"] for r in out)
