"""Data I/O: vector/graph file loaders and the benchmark report writer."""

from pacmann_tpu_torch.io import loaders, report  # noqa: F401
