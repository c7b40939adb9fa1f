"""The seeded inputs and the reference's AES."""

from __future__ import annotations

import numpy as np
import torch

from pbench import data
from pbench.sample import Sample
from reference import aes


def rows_of(seed, n=5000, ids=(0, 1, 4999)):
    return data.rows(torch.tensor(ids), n=n, dim=128, m=32,
                     salt=data.salts(seed))


def test_rows_follow_the_seed():
    big = 2**31 + 12345
    assert torch.equal(rows_of(big), rows_of(big))
    assert not torch.equal(rows_of(big), rows_of(big + 1))
    r = rows_of(big)
    vec = r[:, :128].view(torch.float32)
    assert bool(((vec >= 0) & (vec < 1)).all())
    assert bool(((r[:, 128:] >= 0) & (r[:, 128:] < 5000)).all())
    full = data.make_rows(5000, dim=128, m=32, seed=big, device="cpu")
    assert torch.equal(full[[0, 1, 4999]], r)
    assert len(torch.unique(full[:, 0])) > 4990


def test_requests_follow_the_seed():
    a = data.query_vectors(7, 3, 4, 128)
    assert np.array_equal(a, data.query_vectors(7, 3, 4, 128))
    assert not np.array_equal(a, data.query_vectors(7, 4, 4, 128))
    assert data.sub_seed(2**31 + 3, 1, 2) < 2**63
    ids = data.start_ids(7, 10_000, 100)
    assert len(np.unique(ids)) == 100


def test_sample_is_a_bounded_seeded_sample():
    def held(seed, n):
        s = Sample(seed, size=8)
        for i in range(n):
            if s.wants(i):
                s.add(i, i)
        return sorted(s.held)

    assert len(held(5, 100)) == 8 and held(5, 100) == held(5, 100)
    assert held(5, 100) != held(6, 100)
    assert len(held(5, 3)) == 3


def test_sample_by_share_spreads_over_the_window():
    """Held by share: about that share of the requests, request 0 always,
    as many late in the window as early, the same for the same seed."""
    def held(seed, n):
        s = Sample(seed, share=0.1)
        for i in range(n):
            if s.wants(i):
                s.add(i, i)
        return sorted(s.held)

    h = held(2**31 + 5, 4000)
    assert h[0] == 0 and 300 <= len(h) <= 500
    assert h == held(2**31 + 5, 4000) and h != held(2**31 + 6, 4000)
    early = sum(i < 2000 for i in h)
    assert abs(early - (len(h) - early)) < 0.25 * len(h)
    assert held(2**31 + 5, 1) == [0]


def test_entry_hash_tells_rows_apart():
    w = data.entry_weights(256, "cpu")
    x = torch.randint(-2**31, 2**31 - 1, (4, 256), dtype=torch.int32)
    y = x.clone()
    y[2, 100] ^= 1
    hx, hy = data.entry_hash(x, w), data.entry_hash(y, w)
    assert torch.equal(hx[[0, 1, 3]], hy[[0, 1, 3]])
    assert not torch.equal(hx[2], hy[2])


def test_aes_matches_fips_197():
    key = bytes(range(16))
    pt = bytes.fromhex("00112233445566778899aabbccddeeff")
    rk = torch.as_tensor(aes.expand_key(key))
    ct = aes.encrypt(rk[None], torch.tensor(list(pt))[None, None])[0, 0]
    assert bytes(ct.tolist()).hex() == "69c4e0d86a7b0430d8cdb78070b4c55a"


def test_cut_prf_differs():
    rk = torch.as_tensor(aes.expand_key(bytes(16)))[None]
    t = torch.arange(64)[None]
    full = aes.prf(rk, t, t, 511)
    assert not torch.equal(full, aes.prf(rk, t, t, 511, rounds=4))
