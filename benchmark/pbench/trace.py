"""A torch.profiler pass over some requests, and what the benchmark reads
from its trace.

The pass records the host's torch operations and the benchmark's own spans
(torch.profiler.record_function, named "bench.<what>") beside every device
operation (kernels, copies, sets; CUPTI). The trace is exported to a
temporary file under $TMPDIR, read back and deleted. The profiler slows
the host many times over, so no wall time is taken from a profiled pass:
device times are, and a wall time comes from an unprofiled pass over the
same requests.
"""

from __future__ import annotations

import bisect
import collections
import json
import os
import re
import tempfile

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation")
SPAN_PREFIX = "bench."
TOP = 10
NAME_CHARS = 80                  # a kernel's name in the breakdown, at most


def span(name: str):
    """A span of the benchmark's own, seen in the trace as bench.<name>."""
    return torch.profiler.record_function(SPAN_PREFIX + name)


def short_kernel(name: str) -> str:
    """A kernel's name without its return type, template arguments and
    parameters: "void staged_kernel<4, false>(Args)" -> "staged_kernel"."""
    name = re.sub(r"^void |\(anonymous namespace\)::", "", name)
    depth, out = 0, []
    for ch in name:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            break
        elif depth == 0:
            out.append(ch)
    return ("".join(out).strip() or name)[:NAME_CHARS]


class Trace:
    """The events of one profiled pass (chrome-trace X events, times in us).
    """

    def __init__(self, events: list):
        x = [e for e in events if e.get("ph") == "X"]
        self.device = sorted(
            ((e["name"], float(e["ts"]), float(e.get("dur", 0)),
              e.get("args", {}).get("correlation"))
             for e in x if e.get("cat") in DEVICE_CATS),
            key=lambda d: d[1])
        self.launch_ts = {e["args"]["correlation"]: float(e["ts"])
                          for e in x if e.get("cat") in LAUNCH_CATS
                          and "correlation" in e.get("args", {})}
        self.host = sorted(((e["name"], float(e["ts"]),
                             float(e["ts"]) + float(e.get("dur", 0)))
                            for e in x if e.get("cat") in HOST_CATS),
                           key=lambda h: (h[1], -h[2]))
        self.spans = [h for h in self.host if h[0].startswith(SPAN_PREFIX)]

    # -- device time -------------------------------------------------------

    def _merged(self) -> list:
        out = []
        for _, ts, dur, _ in self.device:
            if out and ts <= out[-1][1]:
                out[-1][1] = max(out[-1][1], ts + dur)
            else:
                out.append([ts, ts + dur])
        return out

    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device."""
        return sum(b - a for a, b in self._merged()) * 1e-6

    def window_s(self) -> float:
        """From the first host event or device operation to the last."""
        starts = [h[1] for h in self.host] + [d[1] for d in self.device]
        ends = [h[2] for h in self.host] + [d[1] + d[2] for d in self.device]
        return (max(ends) - min(starts)) * 1e-6 if starts else 0.0

    def kernel_s(self, pattern: str) -> float:
        """Total seconds of the device operations whose name matches the
        regular expression."""
        rx = re.compile(pattern)
        return sum(d[2] for d in self.device if rx.search(d[0])) * 1e-6

    def span_device_s(self, name: str) -> list[float]:
        """Per instance of span bench.<name>: the device seconds of the
        operations launched while it was open."""
        spans = [h for h in self.spans if h[0] == SPAN_PREFIX + name]
        starts = [s[1] for s in spans]
        out = [0.0] * len(spans)
        for _, _, dur, corr in self.device:
            ts = self.launch_ts.get(corr)
            if ts is None:
                continue
            i = bisect.bisect_right(starts, ts) - 1
            if i >= 0 and ts <= spans[i][2]:
                out[i] += dur * 1e-6
        return out

    # -- what the host was doing ------------------------------------------

    def _host_at(self, times: list[float]) -> list[str]:
        """For each host time (sorted), "outer/inner": the outermost
        benchmark span and the innermost host operation open then."""
        names, stack, j = [], [], 0
        for t in times:
            while j < len(self.host) and self.host[j][1] <= t:
                while stack and stack[-1][2] < self.host[j][1]:
                    stack.pop()
                stack.append(self.host[j])
                j += 1
            while stack and stack[-1][2] < t:
                stack.pop()
            outer = next((h[0][len(SPAN_PREFIX):] for h in stack
                          if h[0].startswith(SPAN_PREFIX)), "")
            inner = stack[-1][0] if stack else "host"
            names.append(f"{outer}/{inner}" if outer else inner)
        return names

    def breakdown(self) -> dict:
        """The TOP device operations by total time (named by the host
        operation that launched them and the kernel), and the TOP idle
        stretches of the device summed by what the host was doing when
        it launched the operation that ended them."""
        launches = [self.launch_ts.get(d[3]) for d in self.device]
        known = sorted({t for t in launches if t is not None})
        at = dict(zip(known, self._host_at(known)))
        ops = collections.Counter()
        for (name, _, dur, _), t in zip(self.device, launches):
            who = at.get(t, "?").rsplit("/", 1)[-1]
            ops[f"{who}:{short_kernel(name)}"] += dur * 1e-6
        gaps = collections.Counter()
        end = None
        for (_, ts, dur, _), t in zip(self.device, launches):
            if end is not None and ts > end:
                gaps[at.get(t, "?")] += (ts - end) * 1e-6
            end = ts + dur if end is None else max(end, ts + dur)
        return {"device_ops": [[k, v] for k, v in ops.most_common(TOP)],
                "idle_gaps": [[k, v] for k, v in gaps.most_common(TOP)]}


def profile(fn) -> Trace:
    """Run fn under torch.profiler (host and CUDA activity) and return its
    trace."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    with torch_profile(activities=activities) as prof:
        fn()
        if cuda:
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return Trace(events)


def idle_share(ctx) -> float | None:
    """100 * (1 - device busy seconds of the profiled pass / wall seconds
    of the same requests unprofiled); None without device operations."""
    if ctx.trace is None or not ctx.trace.device or ctx.unprofiled_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.unprofiled_s)
