"""Host part of a hint generation (pir/device_engine.py::
DevicePianoEngine.preprocessing): the program's spans prep.draw (the
rng's replacement offsets and keys), prep.keys (the AES key schedule) and
prep.upload (the copies to the device), summed over the run's tracing
pass and taken a prep (pbench/program.py::tracing_pass, no profiler)."""

from pbench import program

HOST = ("prep.draw", "prep.keys", "prep.upload")


def read(ctx):
    rec = program.tracing_pass(ctx)
    if rec is None or not rec.counters.get("preps"):
        return None
    return sum(program.span_ms(rec, HOST)) / rec.counters["preps"]
