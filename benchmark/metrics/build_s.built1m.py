"""Seconds of the graph build in the run's set-up (graph/build.py::
build_graph): the program's request span "build", recorded with the
program's tracing on around the set-up build (entries/built_search.py)."""


def read(ctx):
    rec = getattr(ctx.cell, "build_recording", None)
    spans = [s for s in rec.spans if s.name == "build"] if rec else []
    return sum(s.end_ns - s.start_ns for s in spans) * 1e-9 if spans \
        else None
