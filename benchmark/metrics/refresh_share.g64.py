"""The share of the window's wall time that the fused search spent in its
hint refreshes (FusedPrivateSearch.maintenance_s: the program's host clock
around each refresh, which ends on a synchronize)."""


def read(ctx):
    w = ctx.window
    if "maintenance_s" not in w or w["wall_s"] <= 0:
        return None
    return 100.0 * w["maintenance_s"] / w["wall_s"]
