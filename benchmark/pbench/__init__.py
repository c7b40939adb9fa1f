"""The harness of the port's benchmark (`python benchmark/run.py`).

It measures `pacmann_tpu_torch` only and never imports `jax` or the JAX
package. Everything that defines the yardstick lives here, under
`benchmark/`, where a change to the program cannot move it:

  spec.py     BENCHMARK.json, and the configuration, traffic mix, entry and
              metric reader that a cell names, found by name;
  data.py     the seeded rows, queries and start vertices (a frozen copy of
              chip_smoke.py's shard_entries formula, seeded);
  bounds.py   the least time a prep or a gather-XOR could take (frozen
              copies of chip_smoke.py's bound and gather_bound);
  syncs.py    host syncs under torch.cuda.set_sync_debug_mode (the frozen
              counting method of chip_smoke.py's fused_step_syncs);
  trace.py    a torch.profiler pass and what is read from its trace;
  sample.py   the seeded sample of requests held for the check;
  cell.py     what every entry shares: the mix's keys checked, the DB on
              the card, the configuration's parameters, the readers'
              context;
  readers.py  what per-layer metrics of one kind share (K2's and the
              prep's rooflines);
  harness.py  one run of one cell: set-up, window, trace, check, result.

Beside it, each found by name: entries/<entry>.py (entries/search.py, the
closed loop of private searches; entries/prep.py, hint generations back
to back), configs/, traffic/, metrics/, and reference/, the plain
reference the check compares with.
"""
