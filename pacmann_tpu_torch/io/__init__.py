"""Data I/O: vector/graph file loaders (numpy only)."""

from pacmann_tpu_torch.io import loaders  # noqa: F401
