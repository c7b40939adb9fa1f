"""Host syncs a beam step at the claim fixpoint of the engine's "xla"
route (pir/device_engine.py::_claim_fixpoint: the bool() that ends each
pass), from the program's counter sync.claim over its counter steps, in
the run's tracing pass (pbench/program.py::tracing_pass)."""

from pbench import program


def read(ctx):
    return program.per_step(program.tracing_pass(ctx), "sync.claim")
