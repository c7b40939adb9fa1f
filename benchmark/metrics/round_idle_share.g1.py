"""The share, in %, of the profiled pass's idle device time charged to the
engine's round (pir/device_engine.py::_round: the program's span "round"
and its children round.select, round.claim, round.scan, round.finish):
each gap between two device operations goes to the innermost program span
open when the operation that ended it was launched
(pbench/program.py::charge_idle). The profiled pass slows the host, as the
breakdown's idle_gaps, which read the same pass, are slowed."""

from pbench import program


def read(ctx):
    charged = program.idle_by_span(ctx)
    total = sum(charged.values()) if charged else 0.0
    if total <= 0:
        return None
    name = program.PREFIX + "round"
    inside = sum(v for k, v in charged.items()
                 if k == name or k.startswith(name + "."))
    return 100.0 * inside / total
