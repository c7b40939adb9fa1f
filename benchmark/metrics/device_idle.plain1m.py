"""The share of the requests' wall time in which the device ran nothing:
1 - (device busy time of the profiled pass) / (wall time of the same
batches in the unprofiled pass), both in the same traced run
(pbench/trace.py::idle_share)."""

from pbench.trace import idle_share


def read(ctx):
    return idle_share(ctx)
