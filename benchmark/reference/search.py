"""The private beam search of a group of queries, worked out step by step
(the reference's graphann/search.go:129-233 with PACMANN's batched
fetches, pianopir/batch-pir.go:178-216).

A query's visited table starts with the `parallel` start vertices nearest
to it. Each of `steps` steps then, for every query of the group:
  1. pops the `parallel` nearest unexplored vertices (equal distances: the
     earlier table slot first); a pop that finds none fetches a padding id
     drawn from the search's generator instead;
  2. wants the m neighbours of each pop that its table does not hold yet;
     across the group only the first copy of a wanted id is fetched;
  3. routes the fetches to the DB's P partitions of psize rows, first come
     first served, at most `quota` a partition: fetch (rank r, partition
     p) is sub-query (r, p) of the step's PIR batch;
  4. takes a fetched row where the PIR batch served its sub-query. The
     served mask is the program's (which sub-queries the PIR client
     served depends on its hint state, the program's own): the reference
     reads it to follow the program, and the check holds the mask apart to
     the configuration's failure bound;
  5. writes each neighbour it took (a row with some nonzero neighbour id,
     the first copy within the query's fetches) into the query's next
     parallel * m table slots, unexplored.
The answer is the k nearest ids of the table (equal distances: the earlier
slot first). Distances are float32 sums in the same order of operations as
the program's, so equal inputs give equal bits.
"""

from __future__ import annotations

import torch

INF = float("inf")


def nearest(dist: torch.Tensor, k: int):
    """The k smallest along the last axis, ties by the lower index."""
    vals, idx = torch.sort(dist, dim=-1, stable=True)
    return vals[..., :k], idx[..., :k]


def first_in_row(ids: torch.Tensor) -> torch.Tensor:
    """(Q, B) -> (Q, B) bool: the first occurrence of each id in its row."""
    vals, perm = torch.sort(ids, dim=1, stable=True)
    head = torch.ones_like(vals, dtype=torch.bool)
    head[:, 1:] = vals[:, 1:] != vals[:, :-1]
    return torch.zeros_like(head).scatter_(1, perm, head)


def rank_in_group(keys: torch.Tensor) -> torch.Tensor:
    """(N,) group keys in arrival order -> each one's arrival rank within
    its group."""
    order = torch.sort(keys, stable=True).indices
    sk = keys[order]
    pos = torch.arange(keys.numel(), device=keys.device)
    start = torch.ones_like(sk, dtype=torch.bool)
    start[1:] = sk[1:] != sk[:-1]
    first = torch.cummax(torch.where(start, pos, 0), 0).values
    rank = torch.empty_like(pos)
    rank[order] = pos - first
    return rank


def beam_search(queries, starts, rand_ids, prog_idx, prog_ok, *, n, psize,
                P, quota, k, steps, parallel, m, row_fn):
    """queries (Qn, d) float32; starts (ids (Ns,), vecs (Ns, d), nbrs
    (Ns, m)); rand_ids (steps, Qn, parallel, m) padding ids; prog_idx and
    prog_ok (steps, quota, P): the program's sub-queries and served mask
    per step. -> (answers (Qn, k) int64, -1 padded; the steps whose
    sub-queries differ from the reference's routing)."""
    dev = queries.device
    Qn, dim = queries.shape
    pm = parallel * m
    F = Qn * pm
    cap = parallel + steps * pm
    sid, svec, snbr = starts
    ids = torch.full((Qn, cap), -1, dtype=torch.int64, device=dev)
    dist = torch.full((Qn, cap), INF, dtype=torch.float32, device=dev)
    nbrs = torch.zeros((Qn, cap, m), dtype=torch.int64, device=dev)
    explored = torch.ones((Qn, cap), dtype=torch.bool, device=dev)
    sd = ((svec[None, :, :] - queries[:, None, :]) ** 2).sum(dim=-1)
    d0, s0 = nearest(sd, parallel)
    ids[:, :parallel] = sid[s0]
    dist[:, :parallel] = d0
    nbrs[:, :parallel] = snbr[s0]
    explored[:, :parallel] = False
    q_rows = torch.arange(Qn, device=dev)
    q_of = q_rows.repeat_interleave(pm)
    f_pos = torch.arange(F, device=dev)
    wrong_routes = []

    for g in range(steps):
        # 1. pop
        d, slots = nearest(torch.where(explored, INF, dist), parallel)
        valid = d < INF
        slots = torch.where(valid, slots, 0)
        explored[q_rows[:, None].expand(-1, parallel)[valid], slots[valid]] \
            = True
        popped = nbrs[q_rows[:, None], slots]                  # (Qn, par, m)
        fid = torch.where(valid[:, :, None], popped, rand_ids[g].long())
        fid = fid.clamp(0, n - 1).reshape(F)
        # 2. wanted, first copy across the group
        held = ids >= 0
        known = torch.isin(q_of * n + fid,
                           (q_rows[:, None] * n + ids)[held])
        wanted = ~known
        first_of_id = torch.full((n,), F, dtype=torch.int64, device=dev)
        first_of_id.scatter_reduce_(0, fid[wanted], f_pos[wanted], "amin")
        fo = first_of_id[fid]                          # F where none wanted
        is_first = wanted & (fo == f_pos)
        # 3. first come, first served within each partition
        part = torch.div(fid, psize, rounding_mode="floor")
        rank = torch.full((F,), quota, dtype=torch.int64, device=dev)
        firsts = is_first.nonzero()[:, 0]
        rank[firsts] = rank_in_group(part[firsts])
        keep = is_first & (rank < quota)
        want_idx = torch.full((quota, P), -1, dtype=torch.int64, device=dev)
        want_idx[rank[keep], part[keep]] = fid[keep] - part[keep] * psize
        if not torch.equal(want_idx, prog_idx[g].long()):
            wrong_routes.append(g)
        # 4. served rows
        served = torch.zeros(F + 1, dtype=torch.bool, device=dev)
        served[:F][keep] = prog_ok[g][rank[keep], part[keep]].bool()
        took = served[torch.where(fo < F, fo, F)]
        row = row_fn(fid)
        vec = row[:, :dim].contiguous().view(torch.float32)
        nb = row[:, dim:dim + m].long()
        cd = ((vec - queries[q_of]) ** 2).sum(dim=-1)
        # 5. write the step's window
        fid_q = fid.reshape(Qn, pm)
        nb_q = nb.reshape(Qn, pm, m)
        take = (~known & took).reshape(Qn, pm) & first_in_row(fid_q) \
            & (nb_q != 0).any(dim=2)
        w = slice(parallel + g * pm, parallel + (g + 1) * pm)
        ids[:, w] = torch.where(take, fid_q, -1)
        dist[:, w] = torch.where(take, cd.reshape(Qn, pm), INF)
        nbrs[:, w] = torch.where(take[:, :, None], nb_q, 0)
        explored[:, w] = ~take

    d, slot = nearest(dist, k)
    out = torch.where(d < INF, torch.gather(ids, 1, slot), -1)
    return out, wrong_routes
