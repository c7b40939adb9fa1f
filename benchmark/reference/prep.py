"""The hint state one PianoPIR prep leaves, worked out from the DB rows and
the prep's rng at a sample of hints (the reference's pianopir/pir.go:
226-251 and 303-352).

For partition p with AES key k_p, hint t of T = Hp + S*R names in chunk s
the entry at offset PRF(k_p, t, s) & (C - 1); backup hint t >= Hp of group
g = (t - Hp) // R skips chunk g. Its parity is the XOR of the rows it
names, where entry (p, s, offset) is row p * psize + s * C + offset, and an
entry past the partition or past n is zero. Each chunk s also draws R
replacement offsets; replacement (s, r) holds the index s * C + offset and
that entry's row.
"""

from __future__ import annotations

import numpy as np
import torch

from reference import aes


def draws(rng: np.random.Generator, *, P: int, S: int, R: int, C: int):
    """The prep's draws in the engine's order: (P, S, R) replacement
    offsets, u32 masked to the chunk, then one 16-byte AES key per
    partition (a frozen copy of the order of pir/device_engine.py:613-620,
    which is the JAX engine's and the reference's pir.go:345-349)."""
    off = (rng.integers(0, 2**32, size=(P, S, R), dtype=np.uint64)
           & np.uint64(C - 1)).astype(np.int64)
    keys = [rng.bytes(16) for _ in range(P)]
    return off, keys


def xor_reduce(x: torch.Tensor, dim: int) -> torch.Tensor:
    x = x.movedim(dim, 0)
    while x.shape[0] > 1:
        if x.shape[0] % 2:
            x = torch.cat([x, torch.zeros_like(x[:1])])
        x = x[0::2] ^ x[1::2]
    return x[0]


def entry_rows(local: torch.Tensor, p: torch.Tensor, *, psize: int, n: int,
               row_fn) -> torch.Tensor:
    """Rows of partition-local entries (zero past the partition or n)."""
    gid = p * psize + local
    real = (local < psize) & (gid < n)
    got = row_fn(gid[real])
    out = torch.zeros(local.shape + (got.shape[1],), dtype=torch.int32,
                      device=local.device)
    out[real] = got
    return out


def hint_sample(rng: np.random.Generator, hints: np.ndarray,
                repl_at: np.ndarray, *, P: int, S: int, R: int, C: int,
                Hp: int, psize: int, n: int, row_fn, device,
                rounds: int = 10) -> dict:
    """The state of the prep whose rng is `rng`, at hints (P, H) and at
    replacements repl_at (P, h, 2) of (chunk, slot): table (P, H, S)
    offsets, parity (P, H, E) words, repl_idx (P, h) and repl_val (P, h, E)
    words, E the row's words. rounds < 10: the PRF cut short."""
    off, keys = draws(rng, P=P, S=S, R=R, C=C)
    rk = torch.as_tensor(np.stack([aes.expand_key(k) for k in keys]),
                         device=device)
    t = torch.as_tensor(hints, dtype=torch.int64, device=device)
    H = t.shape[1]
    s = torch.arange(S, device=device)
    tags = t[:, :, None].expand(P, H, S).reshape(P, H * S)
    xs = s.expand(P, H, S).reshape(P, H * S)
    table = aes.prf(rk, tags, xs, C - 1, rounds).reshape(P, H, S)
    skip = (t[:, :, None] >= Hp) & (s == torch.div(
        t[:, :, None] - Hp, R, rounding_mode="floor"))
    p_ix = torch.arange(P, device=device)
    rows = entry_rows(s * C + table, p_ix[:, None, None], psize=psize, n=n,
                      row_fn=row_fn)
    rows[skip] = 0
    parity = xor_reduce(rows, 2)

    ra = torch.as_tensor(repl_at, dtype=torch.int64, device=device)
    rs, rr = ra[..., 0], ra[..., 1]
    repl_idx = torch.as_tensor(off, device=device)[
        p_ix[:, None], rs, rr] + rs * C
    repl_val = entry_rows(repl_idx, p_ix[:, None], psize=psize, n=n,
                          row_fn=row_fn)
    return dict(table=table, parity=parity, repl_idx=repl_idx,
                repl_val=repl_val)
