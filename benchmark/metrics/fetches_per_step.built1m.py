"""Distinct wanted fetches a beam step of the fused search
(private/fused_search.py): the program's counter search.fetches_wanted,
the ids a step sends to the PIR routing after its dedup, over the "steps"
of the run's tracing pass (pbench/program.py::tracing_pass)."""

from pbench import program

COUNTER = "search.fetches_wanted"


def read(ctx):
    rec = program.tracing_pass(ctx)
    if rec is None or COUNTER not in rec.counters:
        return None
    return program.per_step(rec, COUNTER)
