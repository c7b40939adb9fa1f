"""Host syncs a call of the engine's batch API
(pir/device_engine.py::DevicePianoEngine.query): every sync-site counter
of the program (sync.query_read, its own reads of entries, served masks
and the budget; sync.claim and sync.refresh_mask, those of its rounds)
summed, over its counter queries, in the tracing pass the batch entry
runs (entries/batch.py::program_pass)."""

from pbench import program


def read(ctx):
    rec = program.tracing_pass(ctx)
    if rec is None or not rec.counters.get("queries"):
        return None
    syncs = sum(v for k, v in rec.counters.items() if k.startswith("sync."))
    return syncs / rec.counters["queries"]
