"""Device time of one PIR round of the engine online
(pir/device_engine.py::DevicePianoEngine._round): the device operations
launched while the benchmark's span around the engine's _round was open,
averaged over the profiled pass's rounds."""


def read(ctx):
    if ctx.trace is None:
        return None
    per = ctx.trace.span_device_s("round")
    if not per or sum(per) <= 0:
        return None
    return 1e3 * sum(per) / len(per)
