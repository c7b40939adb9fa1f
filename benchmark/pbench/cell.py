"""What every entry of a traffic mix (entries/<entry>.py) shares: the
mix's keys held against what the entry runs, the deployment's DB on the
card, its parameters held against the configuration, and the context a
per-layer metric's reader gets."""

from __future__ import annotations

import dataclasses
import time

import torch

from pbench import data
from pbench.spec import SpecError

# request indices of the runs outside the window (warm-up, the traced
# passes), apart from the window's 0, 1, 2, ...
WARM, TRACE_SYNC, TRACE_PASS = 1 << 40, 1 << 41, 1 << 42


@dataclasses.dataclass
class Context:
    """What a --trace 1 run hands each per-layer metric's reader.

    window:       the entry's record of the measured window;
    counters:     counts taken in the traced run (host syncs, steps, ...);
    trace:        the profiled pass's Trace (pbench/trace.py), or None;
    unprofiled_s: the wall seconds of the same requests, unprofiled;
    traced:       how many requests each of the two passes ran;
    cell:         the entry, for what it can work out from the program's
                  state (bounds)."""
    device: torch.device
    window: dict
    counters: dict
    trace: object
    unprofiled_s: float
    traced: int
    cell: object


class Cell:
    """One deployment (a configuration file) on one device.

    MIX_KEYS: the keys of a traffic mix the entry reads, besides `entry`,
    `loop` and `clients`. Every entry runs one client in a closed loop (the
    next request starts when the last has returned), so a mix that asks
    for another loop or more clients, or holds a key the entry does not
    read, is refused rather than run as something it does not say."""

    MIX_KEYS: frozenset = frozenset()

    def __init__(self, cfg: dict, mix: dict, seed: int, device,
                 control: bool = False):
        unknown = set(mix) - self.MIX_KEYS - {"entry", "loop", "clients"}
        if unknown or mix.get("loop") != "closed" or mix.get("clients") != 1:
            raise SpecError(
                f"entry {mix.get('entry')!r} runs one client in a closed "
                f"loop and reads {sorted(self.MIX_KEYS)}; the mix asks for "
                f"loop {mix.get('loop')!r}, clients {mix.get('clients')!r}"
                + (f" and holds {sorted(unknown)}" if unknown else ""))
        self.cfg, self.mix, self.seed = cfg, mix, seed
        self.device = torch.device(device)
        self.control = control
        self.n, self.dim, self.m = cfg["n"], cfg["d"], cfg["m"]
        self.entry_bytes = 4 * (self.dim + self.m)
        self.salt = data.salts(seed)
        self.derived = cfg["derived"]
        self.engine = None
        self.rows_peak = 0

    def row_fn(self, gid: torch.Tensor) -> torch.Tensor:
        return data.rows(gid, n=self.n, dim=self.dim, m=self.m,
                         salt=self.salt)

    def build_engine(self, failure_prob_log2: int):
        """The rows made on the card, then handed to the engine, which
        packs them; the rows are freed, the packed DB stays.

        The device's peak counter restarts once the rows are made, so that
        peak_mem_gb counts from the hand-over on: the rows the engine is
        given, its pack beside them, and all it holds afterwards. The peak
        of making the rows, the benchmark's own work, is kept apart in
        rows_peak for memory_peak_bytes."""
        from pacmann_tpu_torch.pir.device_engine import DevicePianoEngine

        t0 = time.perf_counter()
        raw = data.make_rows(self.n, dim=self.dim, m=self.m, seed=self.seed,
                             device=self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            self.rows_peak = torch.cuda.max_memory_allocated(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
        t1 = time.perf_counter()
        self.engine = DevicePianoEngine(
            self.n, self.entry_bytes, self.cfg["batch"], raw,
            failure_prob_log2, device=self.device)
        del raw
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.setup_parts = dict(rows_s=t1 - t0,
                                pack_s=time.perf_counter() - t1)
        if failure_prob_log2 == self.cfg["failure_prob_log2"]:
            got = derived_params(self.engine)
            if got != self.derived:
                raise ValueError(f"the engine derives {got}, the "
                                 f"configuration states {self.derived}")

    def release(self):
        """Drop the program's state and DB (before the check runs)."""
        self.engine = None


def derived_params(engine) -> dict:
    """The protocol parameters an engine derived, named as the
    configuration files state them."""
    p, c = engine.params, engine.config
    return dict(P=c.partition_num, psize=c.partition_size, C=p.chunk_size,
                S=p.set_size, Hp=p.primary_hint_num,
                R=p.max_query_per_chunk,
                T=p.primary_hint_num + p.set_size * p.max_query_per_chunk,
                max_query_num=p.max_query_num, k=engine.k)
