"""Host time of one beam step of the fused search
(private/fused_search.py::FusedPrivateSearch.run_steps): the mean length
of the program's "step" spans in the run's tracing pass, which runs with
no profiler (pbench/program.py::tracing_pass)."""

from pbench import program


def read(ctx):
    rec = program.tracing_pass(ctx)
    ms = program.span_ms(rec, ("step",)) if rec is not None else []
    return sum(ms) / len(ms) if ms else None
