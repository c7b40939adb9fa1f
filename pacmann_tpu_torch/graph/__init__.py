"""Graph ANN: the plaintext beam search engines, recall and the k-means
start vertices (the rest of the graph build is not ported yet)."""

from pacmann_tpu_torch.graph.beam import PlaintextEngine  # noqa: F401
from pacmann_tpu_torch.graph.beam_host import BasicGraphOracle, BeamSearcher  # noqa: F401
from pacmann_tpu_torch.graph.recall import brute_force_knn, compute_recall  # noqa: F401
