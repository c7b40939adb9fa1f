"""Host syncs a beam step in the fused search's step loop
(private/fused_search.py::FusedPrivateSearch.run_steps), counted under
torch.cuda.set_sync_debug_mode("warn") over the traced run's sync
searches (pbench/syncs.py)."""


def read(ctx):
    c = ctx.counters
    if not c.get("run_steps_steps") or not c.get("control_syncs"):
        return None
    return c["run_steps_syncs"] / c["run_steps_steps"]
