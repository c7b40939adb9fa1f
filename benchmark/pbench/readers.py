"""What per-layer metrics of one kind share, each metric's reader file
(metrics/<metric>.py) naming the kind it reads. A reader returns None
where the run holds nothing for it to read."""

from __future__ import annotations

from pbench.bounds import K2_KERNELS


def k2_roofline(ctx):
    """Kernel K2's share of its bound in a prep, in %: the gather_bound
    of the installed state's offsets over K2's device time a prep in the
    profiled pass (either form)."""
    if ctx.trace is None or not ctx.traced:
        return None
    k2_s = ctx.trace.kernel_s(K2_KERNELS) / ctx.traced
    if k2_s <= 0:
        return None
    return 100.0 * ctx.cell.k2_bound()["bound_ms"] / 1e3 / k2_s


def prep_roofline(ctx):
    """A hint generation's share of its least time, in %: the user bytes
    of the rows its hints name, read once, and the bytes of the state it
    leaves, written once, at the card's HBM rate (bounds.prep_bound), over
    the mean of the window's preps' preprocessing_time (the program's host
    clock, ending on a synchronize)."""
    times = ctx.window.get("prep_s")
    if not times or ctx.device.type != "cuda":
        return None
    least_s = ctx.cell.prep_bound()["bound_ms"] / 1e3
    return 100.0 * least_s / (sum(times) / len(times))
