"""The benchmark's own tests: `python -m pytest benchmark/tests -q`.

They run on the CPU at a tiny size (the program's plain versions), except
those marked `card`, which need a CUDA device and skip without one (the
test decides, not this file). `tiny_root` is a temporary checkout root
whose BENCHMARK.json holds the benchmark's cells plus tiny ones
(tiny.g1, tiny.g4, tiny.prep on an 8,192-row deployment), written as a
later change would add them: new files and new entries only.
"""

from __future__ import annotations

from pathlib import Path

import pytest
from bench_support import make_tiny_root


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    return make_tiny_root(tmp_path_factory.mktemp("checkout"))
