"""One call of the batch-PIR client's batch API, worked out again from its
ids (the reference's pianopir/batch-pir.go:170-248, with the port's retry
rounds as DevicePianoEngine.query documents them):

  1. the ids wanted are the batch's distinct ids in first-come order,
     leaving out those the client's response cache held at the call's
     start (an in-batch repeat hits the cache, pir.go:381-383);
  2. a round routes them first come, first served, to the P partitions of
     psize rows, at most quota = len(ids) // P a partition: the round's
     (quota, P) table of local indices, -1 where a slot is left empty;
  3. the first round runs, then `retries` retry rounds, each re-issuing
     the ids the last round left over (the FCFS overflow first, in order,
     then its routed ids the PIR batch did not serve). A retry round is
     skipped only where the budget guard says so from public state: the
     budget reading at the call's start plus the round's worst case,
     (round + 1) * quota, reaches max_query_num - 2;
  4. an id is answered with its row where some round served it or the
     cache held it at the start, and with zeros where neither: the lossy
     contract (TestBatchPIRBasic).

Which routed id a round served depends on the client's hint state, the
program's own, so the replay reads the program's served mask to follow it,
and the check holds that mask apart to the failure bound, by fetch: the
share of the ids some round routed that no round served. Rows are the
benchmark's hashed rows (row_fn), found again here for each id. Plain
numpy and torch; nothing of the port is imported.
"""

from __future__ import annotations

import numpy as np
import torch


def wanted(ids, cached) -> list[int]:
    """Distinct ids in first-come order, those cached at the start left
    out."""
    out, seen = [], set()
    for g, hit in zip(ids, cached):
        g = int(g)
        if not hit and g not in seen:
            out.append(g)
            seen.add(g)
    return out


def fcfs(want: list[int], *, quota: int, P: int, psize: int):
    """-> (the round's (quota, P) table of global ids, -1 empty; the ids
    left over, in order)."""
    table = np.full((quota, P), -1, np.int64)
    filled = np.zeros(P, np.int64)
    over = []
    for g in want:
        p = g // psize
        if filled[p] < quota:
            table[filled[p], p] = g
            filled[p] += 1
        else:
            over.append(g)
    return table, over


def rounds_due(*, quota: int, retries: int, used: int,
               max_query_num: int) -> int:
    """How many rounds the call runs: 1 + retries, fewer where the budget
    guard skips a retry round; none where quota is 0."""
    if quota == 0:
        return 0
    for rnd in range(1, 1 + max(retries, 0)):
        if used + (rnd + 1) * quota >= max_query_num - 2:
            return rnd
    return 1 + max(retries, 0)


def replay(ids, cached, prog_idx, prog_ok, *, P: int, psize: int):
    """Follow the program's rounds (prog_idx, prog_ok: (rounds, quota, P)
    local indices and served masks). -> (rounds whose table differs from
    the reference's, the ids served, the ids some round routed)."""
    quota = len(ids) // P
    want = wanted(ids, cached)
    wrong = 0
    served: set[int] = set()
    routed: set[int] = set()
    part = np.arange(P, dtype=np.int64)[None, :]
    for idx, ok in zip(prog_idx, prog_ok):
        table, over = fcfs(want, quota=quota, P=P, psize=psize)
        local = np.where(table >= 0, table - part * psize, -1)
        ok = np.asarray(ok, bool)
        if ok.shape != table.shape:
            # a round of another shape than the contract's: nothing of it
            # can be followed
            return len(prog_idx), served, routed
        if not np.array_equal(local, np.asarray(idx, np.int64)):
            wrong += 1
        live = table >= 0
        served.update(int(g) for g in table[live & ok])
        routed.update(int(g) for g in table[live])
        want = over + [int(g) for g in table[live & ~ok]]
    return wrong, served, routed


def _rows(gid: np.ndarray, words: int, row_fn, device) -> torch.Tensor:
    """(len(gid), words) int32: each id's hashed row, zero padded."""
    out = torch.zeros((len(gid), words), dtype=torch.int32, device=device)
    if len(gid):
        r = row_fn(torch.as_tensor(gid, dtype=torch.int64, device=device))
        out[:, :r.shape[1]] = r
    return out


def check_batch(held: dict, *, P: int, psize: int, retries: int,
                max_query_num: int, row_fn, device) -> dict:
    """One held call: ids (B,), cached (B,) bool at the start, used (the
    budget reading at the start), idx / ok (rounds, quota, P), entries
    (rounds, quota, P, words) int32 as the rounds returned them, rows
    (B, E) u32 returned. -> the counts the check sums:

      routes_wrong   rounds whose FCFS table is not the reference's;
      rows_wrong     served entries that are not their id's row;
      answers_wrong  returned rows that are not the contract's: the id's
                     row where a round served it or the cache held it,
                     zeros elsewhere;
      rounds_wrong   |rounds run - rounds due|;
      routed, unserved  the ids some round routed, and of them those no
                     round served: the guarantee is per fetch. A fetch a
                     round misses is re-issued in the retry round, which
                     misses it again unless the hints changed between (a
                     hint miss is a chunk offset no primary hint names), so
                     counted by sub-query most misses would count twice."""
    ids = np.asarray(held["ids"], np.int64)
    idx, ok = np.asarray(held["idx"]), np.asarray(held["ok"], bool)
    quota = len(ids) // P
    due = rounds_due(quota=quota, retries=retries, used=held["used"],
                     max_query_num=max_query_num)
    routes, served, routed = replay(ids, held["cached"], idx, ok, P=P,
                                    psize=psize)
    # every served entry against its row
    entries = np.asarray(held["entries"])
    live = (idx >= 0) & ok
    gid = (np.arange(P, dtype=np.int64) * psize + idx)[live]
    ent = torch.as_tensor(entries[live], device=device)
    rows_wrong = int((ent != _rows(gid, entries.shape[-1], row_fn, device))
                     .any(-1).sum())
    # every returned row against the contract
    got = torch.as_tensor(np.asarray(held["rows"]).view(np.int32),
                          device=device)
    answered = np.array([g in served for g in ids.tolist()]) \
        | np.asarray(held["cached"], bool)
    want = _rows(ids, got.shape[1], row_fn, device)
    want[torch.as_tensor(~answered, device=device)] = 0
    answers_wrong = int((got != want).any(-1).sum())
    return dict(routes_wrong=routes, rows_wrong=rows_wrong,
                answers_wrong=answers_wrong,
                rounds_wrong=abs(len(idx) - due), routed=len(routed),
                unserved=len(routed - served))
