"""Fused private search over the device engine."""
