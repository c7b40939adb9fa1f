"""An exact k-NN batch's share of its least time, in %: the batch's bound
(pbench/knn.py: the squared-L2 work of its queries against every vector at
the card's fp32 FMA peak, 3.83 ms for 1,000 queries x 1M vectors of 128)
over the mean latency of the window's batch calls (the queries uploaded,
graph/recall.py::knn_search, the ids on the host; the host's clock).

The program's "knn" span is not that time: knn_search waits for nothing on
the card, so its span closes once the batch's work is launched."""


def read(ctx):
    lat = ctx.window.get("latency_s")
    if not lat or ctx.device.type != "cuda":
        return None
    least_s = ctx.cell.knn_bound()["bound_ms"] / 1e3
    return 100.0 * least_s / (sum(lat) / len(lat))
