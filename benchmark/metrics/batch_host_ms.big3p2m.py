"""Host time of one call of the engine's batch API
(pir/device_engine.py::DevicePianoEngine.query): the mean length of the
program's "query" spans less their "round" children (the PIR rounds, whose
host time waits on the device), and less any re-prep inside them (none in
the pass: it starts from a fresh prep), in the tracing pass the batch
entry runs (entries/batch.py::program_pass: the traced batches, tracing
on, no profiler)."""

from pbench import program


def read(ctx):
    rec = program.tracing_pass(ctx)
    if rec is None:
        return None
    calls = [s for s in rec.spans if s.name == "query"]
    if not calls:
        return None
    ids = {s.id for s in calls}
    inner = sum(s.end_ns - s.start_ns for s in rec.spans
                if (s.name == "round" and s.parent in ids)
                or (s.name == "prep" and s.request in ids))
    outer = sum(s.end_ns - s.start_ns for s in calls)
    return (outer - inner) * 1e-6 / len(calls)
