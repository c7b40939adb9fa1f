"""Kernels and their plain torch versions."""
