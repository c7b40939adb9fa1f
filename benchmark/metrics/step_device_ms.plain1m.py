"""Device time of one step of the plaintext beam search (graph/beam.py::
PlaintextEngine.search: pop, fetch, dedup and the step's table writes):
the device operations launched while the program's span "ann.step" was
open in the profiled pass (pbench/program.py::span_device_ms), over the
program's counter "ann.steps" of the run's tracing pass, which runs the
same batches (pbench/program.py::tracing_pass). None where the program
has no such span or counter."""

from pbench import program

NAME = "ann.step"


def read(ctx):
    per_span = program.span_device_ms(ctx, NAME)
    rec = program.tracing_pass(ctx)
    if per_span is None or rec is None or not rec.counters.get("ann.steps"):
        return None
    spans = sum(h[0] == program.PREFIX + NAME for h in ctx.trace.host)
    return per_span * spans / rec.counters["ann.steps"]
