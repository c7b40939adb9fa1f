"""The benchmark's plain reference: what the port's timed path should
produce, worked out again in plain torch and numpy from the benchmark's own
inputs. It imports nothing of the port (`pacmann_tpu_torch`) and nothing of
the JAX package; where it needs the protocol's PRF, key schedule or the
engine's draw order, it holds frozen copies of its own.

  aes.py     AES-128 (FIPS-197) and the PRF low32(AES-128-MMO) & mask;
  prep.py    the hint state a prep leaves, at sampled hints;
  search.py  the beam search a group of queries runs, step by step.
"""
