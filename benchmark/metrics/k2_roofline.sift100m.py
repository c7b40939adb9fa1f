"""Kernel K2's share of its bound in a prep of cell shard100m.prep
(ops/xor_scan.py -> csrc/xor_gather.cu, chunk-major or row-split form):
chip_smoke.py's gather_bound (pbench/bounds.py) of the installed state's
offsets, over K2's device time a prep in the profiled pass."""

from pbench.readers import k2_roofline as read  # noqa: F401
