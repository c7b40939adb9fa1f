"""The readers of the program's own tracing (pbench/program.py): idle gaps
charged to the innermost program span, device time a span, the tracing
pass; and a program without the tracing gives None, not an error."""

from __future__ import annotations

import sys

import pytest
from bench_support import HARNESS

from pbench import harness, program
from pbench import spec as specmod
from pbench.trace import Trace

# host spans (name, start, end) and device operations (start, length,
# launched at) in us; a launch of None is not in the trace
HOST = [("bench.search", 0, 100), ("pacmann.search", 0, 100),
        ("pacmann.round", 10, 40), ("pacmann.round.select", 12, 20),
        ("pacmann.step.update", 50, 60), ("pacmann.step.route", 62, 64),
        ("aten::copy_", 13, 14)]
DEVICE = [(5, 2, 1), (15, 3, 14), (30, 5, 25), (55, 1, 52), (120, 1, 110),
          (121.5, 1, None), (121.6, 0.5, 63)]
# the gaps before the 2nd to 6th operations, by the span that launched the
# operation ending them
WANT = {"pacmann.round.select": 8, "pacmann.round": 12,
        "pacmann.step.update": 20, program.NONE: 64 + 0.5}


def synthetic() -> Trace:
    ev = [dict(ph="X", cat="user_annotation" if n.startswith(("bench.",
                                                               "pacmann."))
               else "cpu_op", name=n, ts=a, dur=b - a) for n, a, b in HOST]
    for corr, (ts, dur, at) in enumerate(DEVICE):
        ev.append(dict(ph="X", cat="kernel", name=f"k{corr}", ts=ts, dur=dur,
                       args=dict(correlation=corr)))
        if at is not None:
            ev.append(dict(ph="X", cat="cuda_runtime", name="launch", ts=at,
                           dur=0.1, args=dict(correlation=corr)))
    return Trace(ev)


class Ctx:
    def __init__(self, trace=None, cell=None):
        self.trace, self.cell = trace, cell


def read(name: str, ctx):
    return specmod._load(HARNESS / "metrics" / f"{name}.py",
                         f"test_{name.replace('.', '_')}").read(ctx)


def test_charged_gaps_sum_to_the_idle_time():
    tr = synthetic()
    charged = program.charge_idle(tr)
    assert charged.keys() == WANT.keys()
    for k, us in WANT.items():
        assert charged[k] == pytest.approx(us * 1e-6)
    gaps = [(b[1] - (a[1] + a[2])) for a, b in zip(tr.device, tr.device[1:])]
    idle = sum(g for g in gaps if g > 0) * 1e-6
    assert sum(charged.values()) == pytest.approx(idle)


def test_innermost_span_at_each_time():
    spans = program.program_spans(synthetic())
    assert program.innermost(spans, [1, 11, 13, 20.5, 45, 63, 200]) == [
        "pacmann.search", "pacmann.round", "pacmann.round.select",
        "pacmann.round", "pacmann.search", "pacmann.step.route",
        program.NONE]


def test_device_readers_on_a_synthetic_trace():
    ctx = Ctx(synthetic())
    assert read("round_idle_share.g1", ctx) == pytest.approx(
        100 * 20 / sum(WANT.values()))
    assert read("select_device_ms.g64", ctx) == pytest.approx(3e-3)
    assert read("route_device_ms.g64", ctx) == pytest.approx(0.5e-3)


def test_readers_give_none_without_the_programs_tracing(monkeypatch):
    """An older program: no tracing module to import, no program span in
    the trace."""
    import pacmann_tpu_torch.utils

    monkeypatch.setitem(sys.modules, "pacmann_tpu_torch.utils.trace", None)
    monkeypatch.delattr(pacmann_tpu_torch.utils, "trace", raising=False)
    tr = synthetic()
    tr.host = [h for h in tr.host if not h[0].startswith("pacmann.")]

    class Cell:
        engine, mix, seed = object(), {"trace_preps": 1}, 1

    ctx = Ctx(tr, Cell())
    for name in ("claim_syncs_per_step.g1", "refresh_syncs_per_step.g1",
                 "step_host_ms.g1", "round_idle_share.g1",
                 "route_device_ms.g64", "select_device_ms.g64",
                 "prep_host_ms.sift1m"):
        assert read(name, ctx) is None, name


@pytest.mark.parametrize("cell,names", [
    ("tiny.g4", ("claim_syncs_per_step.g1", "refresh_syncs_per_step.g1",
                 "step_host_ms.g1")),
    ("tiny.prep", ("prep_host_ms.sift1m",)),
])
def test_tracing_pass_readers_on_the_cpu(tiny_root, cell, names):
    """The tiny cells' traced run on the CPU: the tracing pass's readers
    give numbers (six scatter-mask syncs a step; a claim pass or more), the
    device trace's give none (no device operations), and the check holds."""
    res = harness.run_cell(tiny_root, cell, 5, 0.2, True, device="cpu")
    assert res["correct"]
    got = {k: v["value"] for k, v in res["metrics"].items()}
    assert all(got[n] > 0 for n in names)
    assert not {"round_idle_share.g1", "route_device_ms.g64",
                "select_device_ms.g64"} & set(got)
    if cell == "tiny.g4":
        assert got["refresh_syncs_per_step.g1"] == 6
        assert got["claim_syncs_per_step.g1"] >= 1
