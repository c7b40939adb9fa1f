"""Private search: the PIR-backed vertex oracle, the fused private search
over the device engine, and the end-to-end driver."""
