"""The share, in %, of the profiled pass's idle device time charged to the
batch API's host work (pir/device_engine.py::DevicePianoEngine.query: the
program's span "query" and its children query.fill, query.read and
query.budget; not its rounds, "round"): each gap between two device
operations goes to the innermost program span open when the operation
that ended it was launched (pbench/program.py::charge_idle). None where
the trace holds no "query" span."""

from pbench import program

NAME = program.PREFIX + "query"


def read(ctx):
    if ctx.trace is None or not any(h[0] == NAME for h in ctx.trace.host):
        return None
    charged = program.idle_by_span(ctx)
    total = sum(charged.values()) if charged else 0.0
    if total <= 0:
        return None
    inside = sum(v for k, v in charged.items()
                 if k == NAME or k.startswith(NAME + "."))
    return 100.0 * inside / total
