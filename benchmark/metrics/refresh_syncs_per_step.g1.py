"""Host syncs a beam step in the round's scatter refresh
(pir/device_engine.py::_pir_finish: six boolean-mask reads a scatter
round, none on the dense form), from the program's counter
sync.refresh_mask over its counter steps, in the run's tracing pass
(pbench/program.py::tracing_pass)."""

from pbench import program


def read(ctx):
    return program.per_step(program.tracing_pass(ctx), "sync.refresh_mask")
