"""The least time of a batch of exact k-NN queries (sift1m_plain's cells),
and kernel K6's name in a trace.

The bound counts the squared-L2 work of the batch, not how a program does
it: every vector and query read once, each answer's id and distance
(12 bytes) written once, and one fused multiply-add (two fp32 flops) per
component of every (query, vector) pair, at the card's fp32 FMA peak
(pbench/bounds.py). A scan that fuses the distances with the selection is
read against the same least time.
"""

from __future__ import annotations

from pbench.bounds import bound

# kernel K6's device function (pacmann_tpu_torch/csrc/l2_distance.cu)
K6_KERNEL = r"l2_distance_kernel"


def knn_bound(n: int, d: int, queries: int, k: int) -> dict:
    """bounds.bound of Q queries' k nearest among n vectors of d fp32."""
    return bound(4 * (n * d + queries * d) + 12 * queries * k,
                 flops=2 * queries * n * d)
