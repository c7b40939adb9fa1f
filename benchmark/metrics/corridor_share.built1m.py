"""The corridor search's share of the set-up graph build, in %: the
program's "build.corridors" spans (graph/build.py::build_graph's beam
search of every vertex's own vector over the navigable graph) over its
"build" span, from the set-up build's recording
(entries/built_search.py)."""


def read(ctx):
    rec = getattr(ctx.cell, "build_recording", None)
    if rec is None:
        return None
    ns = {}
    for s in rec.spans:
        ns[s.name] = ns.get(s.name, 0) + s.end_ns - s.start_ns
    if not ns.get("build") or "build.corridors" not in ns:
        return None
    return 100.0 * ns["build.corridors"] / ns["build"]
