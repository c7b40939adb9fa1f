"""Graph ANN: the graph build, the plaintext beam search engines, the
cluster baseline, recall."""

from pacmann_tpu_torch.graph.build import build_graph  # noqa: F401
from pacmann_tpu_torch.graph.beam import PlaintextEngine  # noqa: F401
from pacmann_tpu_torch.graph.beam_host import BasicGraphOracle, BeamSearcher  # noqa: F401
from pacmann_tpu_torch.graph.recall import brute_force_knn, compute_recall  # noqa: F401
