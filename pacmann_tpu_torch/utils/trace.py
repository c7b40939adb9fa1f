"""The port's own tracing: spans at its layer boundaries and counters at
its host sync sites.

    with trace.span("prep.k1"): ...          # a phase of the program
    trace.count("sync.claim")                # one host sync, by site
    with trace.enabled():                    # record, from a clean slate
        fs.search(...)
    rec = trace.read()                       # rec.spans, rec.counters

Tracing is on inside `enabled()` and while a torch.profiler is active in
the process (torch's own flag, torch.autograd.profiler's
_is_profiler_enabled). Off, a span or a count is one test of those two
flags: the span is a shared no-op context, so it reads no clock, opens no
record_function and allocates nothing.

Inside `enabled()` each span records its name, its start and end
(time.perf_counter_ns), its id, its parent's id and the id of the request
it belongs to: the outermost open "search", "prep", "query", "build",
"knn" or "ann" span (None outside one); and the counters count. The records and the
counters are kept in memory until the next `enabled()` and read out with
`read()`. While a profiler is active a span opens
record_function("pacmann.<name>"), so that it sits in the profiler's trace
on the same clock as the device operations launched inside it; under the
profiler alone nothing is kept in memory.

`timed(name)` is a span that reads the clock whether tracing is on or
off: the program's always-on times (DevicePianoEngine.preprocessing_time,
FusedPrivateSearch.maintenance_s, build_graph's stats["phases"]) are the
seconds of their "prep", "search.refresh" and "build.<stage>" spans. No
other span reads the clock when tracing is off.
"""

from __future__ import annotations

import contextlib
import itertools
import time
from typing import NamedTuple

from torch.autograd import profiler as _profiler
from torch.autograd.profiler import record_function

PREFIX = "pacmann."
REQUESTS = ("search", "prep", "query", "build", "knn", "ann")


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: int | None
    request: int | None


class Recording(NamedTuple):
    spans: list
    counters: dict


_enabled = False
_spans: list[Span] = []
_counters: dict[str, int] = {}
_open: list[tuple[int, int | None]] = []     # (id, request) of open spans
_ids = itertools.count(1)
_NOOP = contextlib.nullcontext()


class _Span:
    """A span while tracing is on, or a timed span (either way)."""

    __slots__ = ("name", "t0", "t1", "live", "kept", "sid", "parent",
                 "request", "rf")

    def __init__(self, name: str):
        self.name = name
        self.live = self.kept = False
        self.rf = None
        self.t0 = self.t1 = 0

    def __enter__(self):
        self.kept = _enabled
        self.live = self.kept or _profiler._is_profiler_enabled
        if self.live:
            self.sid = next(_ids)
            self.parent, outer = _open[-1] if _open else (None, None)
            self.request = outer if outer is not None else (
                self.sid if self.name in REQUESTS else None)
            _open.append((self.sid, self.request))
            if _profiler._is_profiler_enabled:
                self.rf = record_function(PREFIX + self.name)
                self.rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter_ns()
        if self.live:
            if self.rf is not None:
                self.rf.__exit__(*exc)
                self.rf = None
            _open.pop()
            if self.kept:
                _spans.append(Span(self.name, self.t0, self.t1, self.sid,
                                   self.parent, self.request))
        return False

    @property
    def seconds(self) -> float:
        """From the span's start to its end."""
        return (self.t1 - self.t0) * 1e-9


def span(name: str):
    """A context manager: the span `name` while tracing is on, else a
    shared no-op."""
    if not (_enabled or _profiler._is_profiler_enabled):
        return _NOOP
    return _Span(name)


def timed(name: str) -> _Span:
    """The span `name`, whose `.seconds` are taken whether tracing is on
    or off."""
    return _Span(name)


def count(name: str, n: int = 1):
    """Add n to counter `name` inside `enabled()`."""
    if _enabled:
        _counters[name] = _counters.get(name, 0) + n


@contextlib.contextmanager
def enabled():
    """Tracing on inside the block, from empty records and counters."""
    global _enabled
    was = _enabled
    _spans.clear()
    _counters.clear()
    _enabled = True
    try:
        yield
    finally:
        _enabled = was


def read() -> Recording:
    """A copy of the span records and the counters kept since the last
    `enabled()`."""
    return Recording(list(_spans), dict(_counters))
