"""Command-line entry points: exact search and the plaintext ANN search."""
