"""PianoPIR / batch-PIR parameter derivation.

These formulas are reproduced *behaviorally verbatim* from the reference —
they set the privacy/failure bounds and the client storage model, so any
drift silently changes the protocol's guarantees:

  ChunkSize/SetSize:      pianopir/pir.go:487-494
  MaxQueryNum:            pir.go:138
  primaryHintNum:         pir.go:124-127,139-140
  maxQueryPerChunk:       pir.go:141-142
  storage model:          pir.go:178-190
  comm model:             pir.go:539-544
  batch partitioning:     batch-pir.go:12-13,62-64
"""

import dataclasses
import math

DEFAULT_PROGRAM_POINT = 0x7FFFFFFF          # pir.go:13-16
REAL_QUERY_PER_PARTITION = 2                # batch-pir.go:13
QUERY_PER_PARTITION = 2                     # batch-pir.go:14
DEFAULT_VALUE = 0xDEADBEEF                  # batch-pir.go:15 (dummy-query marker)


@dataclasses.dataclass(frozen=True)
class PianoParams:
    """Derived configuration of one PianoPIR instance (pir.go:18-26,479-514)."""

    db_size: int                  # number of entries
    entry_bytes: int              # bytes per entry
    chunk_size: int               # power of two >= 2*sqrt(db_size)
    set_size: int                 # ceil(db_size/chunk_size) rounded up to x4
    max_query_num: int            # floor(sqrt(n) * ln(n))
    primary_hint_num: int
    max_query_per_chunk: int
    failure_prob_log2: int
    thread_num: int = 8           # pir.go:502 — only used for hint-count rounding

    @property
    def entry_u32(self) -> int:
        return self.entry_bytes // 4

    @property
    def chunk_mask(self) -> int:
        return self.chunk_size - 1

    @property
    def total_backup_hints(self) -> int:
        return self.set_size * self.max_query_per_chunk

    @property
    def total_tags(self) -> int:
        """Primary tags [0, Hp) then backup tags [Hp, Hp + S*R) (pir.go:226-251)."""
        return self.primary_hint_num + self.total_backup_hints

    def local_storage_bytes(self) -> float:
        """Client storage model, identical accounting to pir.go:178-190."""
        s = 0.0
        s += self.primary_hint_num * 8                      # primary short tags
        s += self.primary_hint_num * self.entry_bytes       # primary parities
        s += self.primary_hint_num * 8                      # program points
        tb = float(self.total_backup_hints)
        s += tb * 8                                         # replacement indices
        s += tb * self.entry_bytes                          # replacement values
        s += tb * 8                                         # backup short tags
        s += tb * self.entry_bytes                          # backup parities
        return s

    def comm_cost_per_query_bytes(self) -> float:
        """Upload SetSize u32 offsets, download one entry (pir.go:539-544)."""
        return float(self.set_size * 4 + (self.entry_bytes // 8) * 8)


def derive_piano_params(
    db_size: int,
    entry_bytes: int,
    failure_prob_log2: int,
    thread_num: int = 8,
) -> PianoParams:
    if entry_bytes % 8 != 0:
        raise ValueError("entry_bytes must be a multiple of 8 (pir.go:480)")
    target_chunk = int(2 * math.sqrt(float(db_size)))
    chunk_size = 1
    while chunk_size < target_chunk:
        chunk_size *= 2
    set_size = math.ceil(float(db_size) / float(chunk_size))
    set_size = (set_size + 3) // 4 * 4

    max_query_num = int(math.sqrt(float(db_size)) * math.log(float(db_size)))

    # primaryNumParam (pir.go:124-127): k = ceil(ln2 * (failLog2+1)) hints/chunk
    k = math.ceil(math.log(2.0) * float(failure_prob_log2 + 1))
    primary_hint_num = int(k) * chunk_size
    primary_hint_num = (
        (primary_hint_num + thread_num - 1) // thread_num * thread_num
    )

    max_query_per_chunk = 3 * int(float(max_query_num) / float(set_size))
    max_query_per_chunk = (
        (max_query_per_chunk + thread_num - 1) // thread_num * thread_num
    )

    return PianoParams(
        db_size=db_size,
        entry_bytes=entry_bytes,
        chunk_size=chunk_size,
        set_size=set_size,
        max_query_num=max_query_num,
        primary_hint_num=primary_hint_num,
        max_query_per_chunk=max_query_per_chunk,
        failure_prob_log2=failure_prob_log2,
        thread_num=thread_num,
    )


def expected_success_rate(wanted: int, partition_num: int, quota: int,
                          failure_prob_log2: int) -> float:
    """Analytic served/wanted rate of the lossy FCFS batch contract.

    The reference drops overflow sub-queries silently (batch-pir.go:229-235)
    and loses each surviving one to a hint miss w.p. 2^-failLog2
    (pir.go:416-419) but records no expected rate; this derives it so the
    measured device counters have a contract to regress against. Model:
    `wanted` fetches with uniform-independent partition assignment — the
    per-partition count X is Binomial(wanted, 1/P) — each partition serves
    min(X, quota):

        E[served]/wanted = P * E[min(X, quota)] / wanted * (1 - 2^-fail)

    Graph-neighbor ids are only approximately uniform, so callers should
    allow a few percent of tolerance; a larger deviation means the routing,
    dedup, or budget logic regressed."""
    P, B, q = partition_num, wanted, quota
    if B <= 0 or P <= 0:
        return 1.0
    if P == 1:
        # degenerate: every fetch lands in the one partition (X == B)
        return min(q, B) / B * (1.0 - 2.0 ** (-failure_prob_log2))
    # E[min(X, q)] = q - sum_{x<q} (q-x) pmf(x), pmf iterated stably
    pr = 1.0 / P
    pmf = (1.0 - pr) ** B
    emin = float(q)
    for x in range(min(q, B)):
        emin -= (q - x) * pmf
        pmf *= (B - x) / (x + 1.0) * pr / (1.0 - pr)
    served = min(P * emin / B, 1.0)
    return served * (1.0 - 2.0 ** (-failure_prob_log2))


@dataclasses.dataclass(frozen=True)
class BatchParams:
    """SimpleBatchPianoPIR partitioning (batch-pir.go:55-93)."""

    db_size: int
    entry_bytes: int
    batch_size: int
    partition_num: int
    partition_size: int
    failure_prob_log2: int

    def partition_range(self, i: int) -> tuple[int, int]:
        start = i * self.partition_size
        end = min((i + 1) * self.partition_size, self.db_size)
        return start, end


def derive_batch_params(
    db_size: int, entry_bytes: int, batch_size: int, failure_prob_log2: int
) -> BatchParams:
    partition_num = batch_size // REAL_QUERY_PER_PARTITION
    partition_size = (db_size + partition_num - 1) // partition_num
    return BatchParams(
        db_size=db_size,
        entry_bytes=entry_bytes,
        batch_size=batch_size,
        partition_num=partition_num,
        partition_size=partition_size,
        failure_prob_log2=failure_prob_log2,
    )
