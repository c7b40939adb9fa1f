"""Device time of an exact k-NN batch's selection (graph/recall.py::
knn_search: each tile's top-k and its merge into the running k best): the
device operations launched while the program's span "knn.select" was
open, over the profiled pass's batches (pbench/program.py::
span_device_ms). None where the trace holds no such span."""

from pbench import program

NAME = "knn.select"


def read(ctx):
    per_span = program.span_device_ms(ctx, NAME)
    if per_span is None or not ctx.traced:
        return None
    spans = sum(h[0] == program.PREFIX + NAME for h in ctx.trace.host)
    return per_span * spans / ctx.traced
