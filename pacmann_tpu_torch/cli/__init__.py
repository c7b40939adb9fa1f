"""Command-line entry points: exact search, the plaintext ANN search, the
cluster baseline and the private search."""
