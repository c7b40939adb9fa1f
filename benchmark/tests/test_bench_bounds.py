"""The least-time counts against hand counts on tiny inputs."""

from __future__ import annotations

import pytest
import torch

from pbench import bounds


def test_bound_takes_the_larger_of_bytes_and_operations():
    b = bounds.bound(3.35e9)                      # 1 ms of HBM
    assert b["bound_ms"] == pytest.approx(1.0) and b["bound_by"] == "bytes"
    ops = bounds.INT32_OPS_PER_S * 2e-3           # 2 ms of int32 logic
    b = bounds.bound(3.35e9, int_ops=ops)
    assert b["bound_ms"] == pytest.approx(2.0)
    assert b["bound_by"] == "operations"


def offsets():
    # P = 2, B = 3, S = 2, C = 4: partition 0 names entries (s0: 1, 1, 2)
    # and (s1: 0, 3, -1 skipped by sign); partition 1 (s0: 3, 3, 3),
    # (s1: 2, 2, 9 out of range)
    off = torch.tensor([[[1, 0], [1, 3], [2, -1]],
                        [[3, 2], [3, 2], [3, 9]]], dtype=torch.int32)
    skip = torch.zeros_like(off, dtype=torch.bool)
    skip[0, 0, 1] = True                          # drops (p0, s1, 0)
    return off, skip


def test_gather_bound_counts_distinct_live_entries():
    off, skip = offsets()
    b, rows = bounds.gather_bound(off, skip, C=4, k=2)
    # live: p0 s0 {1, 2}, p0 s1 {3}, p1 s0 {3}, p1 s1 {2}
    assert rows == 5
    live = 3 + 1 + 3 + 2
    want = rows * 2 * 512 + off.numel() * 4 + skip.numel() + 2 * 3 * 2 * 512
    assert b["bound_bytes"] == want
    assert b["bound_int_ops"] == live * 2 * 128


def test_prep_bound_counts_user_rows_and_state_bytes():
    off, skip = offsets()
    # psize 7, n 12: entry (p, s, o) is row 7p + 4s + o, local 4s + o < 7
    # live distinct: p0 local {1, 2, 7}, p1 local {3, 6}; local 7 is past
    # the partition, and p1 local 6 is row 13 >= n
    state = {"a": torch.zeros(10, dtype=torch.int32),
             "b": torch.zeros(3, 4, dtype=torch.int64)}
    b = bounds.prep_bound(off, skip, state, C=4, psize=7, n=12,
                          entry_bytes=640)
    assert b["named_rows"] == 3
    assert b["state_bytes"] == 40 + 96
    assert b["bound_bytes"] == 3 * 640 + 136
