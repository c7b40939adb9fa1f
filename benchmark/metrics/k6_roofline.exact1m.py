"""Kernel K6's share of an exact k-NN batch's least time, in %: the
batch's bound (pbench/knn.py, the squared-L2 work, 3.83 ms for 1,000
queries x 1M vectors of 128) over K6's device time a batch in the profiled
pass (l2_distance_kernel, pacmann_tpu_torch/csrc/l2_distance.cu)."""

from pbench.knn import K6_KERNEL


def read(ctx):
    if ctx.trace is None or not ctx.traced:
        return None
    k6_s = ctx.trace.kernel_s(K6_KERNEL) / ctx.traced
    if k6_s <= 0:
        return None
    return 100.0 * ctx.cell.knn_bound()["bound_ms"] / 1e3 / k6_s
