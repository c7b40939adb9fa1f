"""What the per-layer metrics that read the program's own tracing
(pacmann_tpu_torch/utils/trace.py: spans "pacmann.<name>" and counters)
share. Each is taken once a run, on the first reader's call, and kept on
the reader's context.

  tracing_pass(ctx)  the traced run's requests once more (after a warm-up
                     pass of them), with the program's tracing on and no
                     profiler: its span records and its counters;
  idle_by_span(ctx)  the profiled pass's idle device time, each gap
                     charged to the innermost program span open on the
                     host when the operation that ended the gap was
                     launched.

Both are None where the program has no such tracing (an older program:
no pacmann_tpu_torch.utils.trace module, no "pacmann." spans in the
trace), so their readers return None there.
"""

from __future__ import annotations

import bisect
import collections

from pbench import data
from pbench.cell import TRACE_PASS

PREFIX = "pacmann."
NONE = ""                   # idle_by_span's key for gaps under no span


def tracing_pass(ctx):
    """-> the tracing pass's record (trace.Recording: spans, counters), or
    None."""
    if not hasattr(ctx, "program_pass"):
        ctx.program_pass = _run_pass(ctx)
    return ctx.program_pass


def _run_pass(ctx):
    """The requests of the entry's traced passes, from the same start:
    the search cells' prep, then their trace_searches searches; the prep
    cells' trace_preps preps. They run twice, tracing off and then on: the
    first pass after a pause (the profiled pass's export, a sleep) ran the
    step loop 1.3-1.9x slower on an H100's host, and warms it for the
    second.
    The search cells' prep runs before tracing is on, as it runs before
    either of the entry's passes."""
    try:
        from pacmann_tpu_torch.utils import trace as program_trace
    except ImportError:
        return None
    cell = ctx.cell
    e, mix, seed = cell.engine, cell.mix, cell.seed
    if e is None:
        return None

    def requests():
        if "trace_searches" in mix:
            for j in range(mix["trace_searches"]):
                cell._search(TRACE_PASS + j)
        else:
            for j in range(mix["trace_preps"]):
                e.preprocessing(rng=data.rng(seed, data.TRACE, j))

    for on in (False, True):
        if "trace_searches" in mix:
            e.preprocessing(rng=data.rng(seed, data.TRACE, 0))
        if on:
            with program_trace.enabled():
                requests()
        else:
            requests()
    return program_trace.read()


def span_ms(rec, names) -> list[float]:
    """The duration in ms of each span record named in `names`."""
    return [(s.end_ns - s.start_ns) * 1e-6 for s in rec.spans
            if s.name in names]


def per_step(rec, counter: str) -> float | None:
    """Counter `counter` over the pass's beam steps."""
    if rec is None or not rec.counters.get("steps"):
        return None
    return rec.counters.get(counter, 0) / rec.counters["steps"]


# -- the profiled pass -------------------------------------------------------

def program_spans(tr) -> list:
    """The trace's program spans (name, start, end), in start order, outer
    before inner."""
    return [h for h in tr.host if h[0].startswith(PREFIX)]


def innermost(spans: list, times: list[float]) -> list[str]:
    """For each host time (sorted): the name of the innermost program span
    open then, or NONE. Spans of one thread nest, so a stack does."""
    names, stack, j = [], [], 0
    for t in times:
        while j < len(spans) and spans[j][1] <= t:
            while stack and stack[-1][2] < spans[j][1]:
                stack.pop()
            stack.append(spans[j])
            j += 1
        while stack and stack[-1][2] < t:
            stack.pop()
        names.append(stack[-1][0] if stack else NONE)
    return names


def charge_idle(tr) -> dict:
    """{span name or NONE: idle seconds}. A gap is a stretch in which the
    device ran nothing, between two of its operations (the breakdown's
    idle_gaps); it is charged to the innermost program span open when the
    operation that ends it was launched, or to NONE where no program span
    was open or the launch is not in the trace. The values sum to the
    pass's idle time between its first and last device operation."""
    launches = [tr.launch_ts.get(d[3]) for d in tr.device]
    known = sorted({t for t in launches if t is not None})
    at = dict(zip(known, innermost(program_spans(tr), known)))
    out = collections.Counter()
    end = None
    for (_, ts, dur, _), t in zip(tr.device, launches):
        if end is not None and ts > end:
            out[at.get(t, NONE)] += (ts - end) * 1e-6
        end = ts + dur if end is None else max(end, ts + dur)
    return dict(out)


def idle_by_span(ctx) -> dict | None:
    if not hasattr(ctx, "program_idle"):
        tr = ctx.trace
        charged = charge_idle(tr) if tr is not None and tr.device else {}
        ctx.program_idle = charged if set(charged) - {NONE} else None
    return ctx.program_idle


def span_device_ms(ctx, name: str) -> float | None:
    """The device ms of the operations launched while program span `name`
    was open, a span instance, over the profiled pass; None where the trace
    holds no such span or no device time inside one."""
    tr = ctx.trace
    if tr is None or not tr.device:
        return None
    spans = [h for h in tr.host if h[0] == PREFIX + name]
    if not spans:
        return None
    starts = [s[1] for s in spans]
    total = 0.0
    for _, _, dur, corr in tr.device:
        ts = tr.launch_ts.get(corr)
        if ts is None:
            continue
        i = bisect.bisect_right(starts, ts) - 1
        if i >= 0 and ts <= spans[i][2]:
            total += dur * 1e-3
    return total / len(spans) if total > 0 else None
