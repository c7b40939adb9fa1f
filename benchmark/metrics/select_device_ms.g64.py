"""Device time of a round's slot selection (pir/device_engine.py::
_pir_select: the claim, the budgets, the query sets): the device
operations launched while the program's span "round.select" was open,
over the profiled pass's rounds (pbench/program.py::span_device_ms)."""

from pbench import program


def read(ctx):
    return program.span_device_ms(ctx, "round.select")
