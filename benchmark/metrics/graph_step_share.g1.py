"""The share of the fused search's beam steps served by CUDA graph
replays (private/fused_search.py::StepGraphs), in %: the program's counter
step.graphed over its "steps" in the run's tracing pass
(pbench/program.py::tracing_pass). None where the program counts no
step.graphed (one that replays no step graphs)."""

from pbench import program

COUNTER = "step.graphed"


def read(ctx):
    rec = program.tracing_pass(ctx)
    if rec is None or COUNTER not in rec.counters:
        return None
    share = program.per_step(rec, COUNTER)
    return None if share is None else 100.0 * share
