"""Device time of a beam step's routing (private/fused_search.py::
_route_core: frontier pop, dedup, FCFS ranks): the device operations
launched while the program's span "step.route" was open, over the
profiled pass's steps (pbench/program.py::span_device_ms)."""

from pbench import program


def read(ctx):
    return program.span_device_ms(ctx, "step.route")
