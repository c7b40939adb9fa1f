"""The port's gather-XOR (plain version of kernel K2) against the JAX
package's three callers of that contract: xor_hintgen_mm (the Pallas
kernel, interpreted on the CPU), xor_scan_parts and xor_gather_multi."""

import subprocess
import sys

import numpy as np
import pytest
import torch

from pacmann_tpu.ops.xor_scan import (
    xor_gather_multi, xor_hintgen_mm, xor_scan_parts)
from pacmann_tpu_torch.ops import xor_scan
from pacmann_tpu_torch.utils import trace
from pacmann_tpu_torch.utils.u32 import from_u32

# Tests run in several worker processes at once; torch's default of one
# intra-op thread per core oversubscribes the machine (measured about
# 4x slower for this file set), and these tensors are small.
torch.set_num_threads(1)


def _db(rng, S, P, C, k):
    return rng.integers(0, 2**32, size=(S, P, C * k, 128), dtype=np.uint32)


@pytest.mark.parametrize("S,P,C,k,T", [(4, 2, 8, 2, 19), (8, 1, 16, 1, 260)])
def test_hintgen_matches_mm_kernel_and_scan(S, P, C, k, T):
    rng = np.random.default_rng(T)
    db4 = _db(rng, S, P, C, k)
    table = rng.integers(0, C, size=(P, T, S), dtype=np.uint32)
    skip = rng.random((P, T, S)) < 0.25
    got = xor_scan.xor_hintgen(from_u32(db4), from_u32(table),
                               torch.from_numpy(skip), k)
    got = got.numpy().view(np.uint32)
    mm = np.asarray(xor_hintgen_mm(db4, table, skip, k, interpret=True))
    parts = np.asarray(xor_scan_parts(db4, table, skip, k)).reshape(
        P, T, k * 128)
    assert np.array_equal(got, mm)
    assert np.array_equal(got, parts)


@pytest.mark.parametrize("k", [5, 8])
def test_gather_plain_takes_entries_over_four_rows(k):
    """Entries over 2 KiB (k > 4 rows; k = 8 is a 960-dimensional vector
    with 32 neighbours, 3,968 B): the plain version equals the JAX
    package's xor_scan_parts, and xor_gather_cuda no longer refuses them
    for their k (it refuses only the CPU tensor)."""
    rng = np.random.default_rng(k)
    S, P, C, B = 3, 2, 8, 7
    db4 = _db(rng, S, P, C, k)
    off = rng.integers(0, C, size=(P, B, S), dtype=np.uint32)
    skip = rng.random((P, B, S)) < 0.25
    got = xor_scan.xor_hintgen(from_u32(db4), from_u32(off),
                               torch.from_numpy(skip), k)
    want = np.asarray(xor_scan_parts(db4, off, skip, k)).reshape(P, B, -1)
    assert np.array_equal(got.numpy().view(np.uint32), want)
    with pytest.raises(ValueError, match="CUDA tensor"):
        xor_scan.xor_gather_cuda(from_u32(db4), from_u32(off), k)


@pytest.mark.parametrize("S,P,C,k,B", [(13, 2, 8, 3, 37), (13, 1, 8, 8, 5),
                                       (13, 2, 4, 3, 9)])
def test_gather_plain_at_ragged_shapes(S, P, C, k, B):
    """The shapes the two K2 forms split unevenly: S not a multiple of the
    8-chunk offset run, k = 3 and 8, B not a multiple of a hint block, and
    rows that skip every chunk; the plain version equals xor_scan_parts
    and the interpreted Pallas kernel."""
    rng = np.random.default_rng(S * 100 + k * 10 + B)
    db4 = _db(rng, S, P, C, k)
    table = rng.integers(0, C, size=(P, B, S), dtype=np.uint32)
    skip = rng.random((P, B, S)) < 0.25
    skip[:, B // 2] = True
    got = xor_scan.xor_hintgen(from_u32(db4), from_u32(table),
                               torch.from_numpy(skip), k)
    got = got.numpy().view(np.uint32)
    parts = np.asarray(xor_scan_parts(db4, table, skip, k)).reshape(P, B, -1)
    mm = np.asarray(xor_hintgen_mm(db4, table, skip, k, interpret=True))
    assert np.array_equal(got, parts)
    assert np.array_equal(got, mm)
    assert not got[:, B // 2].any()


# (P, B, S, C, k) -> form: the SIFT1M prep at k = 2, 5, 8; the 5M prep,
# whose C = 2,048 rows a chunk do not fit the shared-memory ring (the
# sliced form serves it); the online scans at Q = 6 and 96; both sides of
# the switch at B = 16C; B = 2C, where the row form was the faster; the
# SIFT100M shard's prep (sliced) and its online scans at Q = 6 and 384
# (row); both sides of the sliced form's switch at B = 2C, C = 8,192
@pytest.mark.parametrize("P,B,S,C,k,form", [
    (16, 12512, 124, 512, 2, "chunk"), (16, 12512, 124, 512, 5, "chunk"),
    (16, 12512, 124, 512, 8, "chunk"), (16, 35552, 156, 2048, 2, "sliced"),
    (16, 6, 124, 512, 2, "row"), (16, 96, 124, 512, 2, "row"),
    (16, 96, 124, 512, 8, "row"), (16, 8191, 124, 512, 2, "row"),
    (16, 8192, 124, 512, 2, "chunk"), (16, 1024, 124, 512, 2, "row"),
    (16, 100000, 124, 1024, 2, "sliced"),
    (4, 179584, 764, 8192, 2, "sliced"), (4, 6, 764, 8192, 2, "row"),
    (4, 384, 764, 8192, 2, "row"), (4, 16383, 764, 8192, 2, "row"),
    (4, 16384, 764, 8192, 2, "sliced")])
def test_gather_form_rule(P, B, S, C, k, form):
    assert xor_scan.gather_form(P, B, S, C, k) == form


@pytest.mark.parametrize("P,B,S,k,warps", [
    (16, 6, 124, 2, 8), (16, 96, 124, 2, 4), (16, 96, 124, 8, 2),
    (16, 96, 124, 5, 1), (16, 6, 13, 2, 2), (1, 1, 3, 1, 1),
    (16, 1536, 124, 2, 1)])
def test_row_split_warps(P, B, S, k, warps):
    """Warps per row double while the launch has fewer than 132 x 32
    warps, up to 8 and to one 8-chunk step per warp."""
    assert xor_scan.row_split_warps(P, B, S, k) == warps


def test_xor_gather_cuda_refuses_an_unknown_form(monkeypatch):
    """A form name the kernel does not have raises before any launch."""
    monkeypatch.setattr(xor_scan.cuda_lib, "require_cuda_tensor",
                        lambda *a: None)
    monkeypatch.setattr(xor_scan.cuda_lib, "function",
                        lambda *a: pytest.fail("reached the library"))
    db4 = torch.zeros((2, 1, 4, 128), dtype=torch.int32)
    off = torch.zeros((1, 3, 2), dtype=torch.int32)
    launches = xor_scan.xor_gather_cuda.launches
    with pytest.raises(ValueError, match="unknown K2 form"):
        xor_scan.xor_gather_cuda(db4, off, 1, form="plane")
    assert xor_scan.xor_gather_cuda.launches == launches


@pytest.mark.parametrize("form,entry,counted", [
    ("sliced", "xor_gather_sliced", 1), ("chunk", "xor_gather_chunk_major", 0),
    ("row", "xor_gather_row_split", 0)])
def test_xor_gather_cuda_launches_its_form(monkeypatch, form, entry, counted):
    """Each form calls its C entry point with (S, P, C, k, B); the sliced
    form counts "k2.sliced" once a launch inside trace.enabled(), and
    nothing is counted outside it."""
    calls = []

    def function(lib, name, argtypes):
        def launch(*args):
            calls.append((lib, name, args[3:8]))
            return 0
        return launch

    monkeypatch.setattr(xor_scan.cuda_lib, "require_cuda_tensor",
                        lambda *a: None)
    monkeypatch.setattr(xor_scan.cuda_lib, "function", function)
    monkeypatch.setattr(xor_scan.cuda_lib, "stream_ptr", lambda device: 0)
    S, P, C, k, B = 5, 3, 4, 2, 7
    db4 = torch.zeros((S, P, C * k, 128), dtype=torch.int32)
    off = torch.zeros((P, B, S), dtype=torch.int32)
    launches = xor_scan.xor_gather_cuda.launches
    with trace.enabled():
        out = xor_scan.xor_gather_cuda(db4, off, k, form=form)
        assert trace.read().counters == ({"k2.sliced": 1} if counted else {})
    xor_scan.xor_gather_cuda(db4, off, k, form=form)
    assert trace.read().counters == ({"k2.sliced": 1} if counted else {})
    assert out.shape == (P, B, k * 128)
    assert calls == [("xor_gather", entry, (S, P, C, k, B))] * 2
    assert xor_scan.xor_gather_cuda.launches == launches + 2


def test_server_scan_matches_gather_multi():
    rng = np.random.default_rng(9)
    S, P, C, k, Q = 4, 3, 8, 2, 5
    db4 = _db(rng, S, P, C, k)
    qs = rng.integers(0, C, size=(Q, P, S), dtype=np.uint32)
    got = xor_scan.xor_server_scan(from_u32(db4), from_u32(qs), k)
    want = np.asarray(xor_gather_multi(db4, qs, k))
    assert got.shape == (Q, P, k, 128)
    assert np.array_equal(got.numpy().view(np.uint32), want)


def test_out_of_range_offsets_are_skips():
    """Any offset outside [0, C) contributes zero, like a skip."""
    rng = np.random.default_rng(3)
    S, P, C, k, B = 3, 2, 4, 1, 6
    db4 = from_u32(_db(rng, S, P, C, k))
    off = torch.from_numpy(rng.integers(0, C, size=(P, B, S)).astype(np.int32))
    skip = torch.zeros((P, B, S), dtype=torch.bool)
    skip[:, :, 1] = True
    want = xor_scan.xor_hintgen(db4, off, skip, k)
    for bad in (-1, C, 1 << 30):
        off2 = off.clone()
        off2[:, :, 1] = bad
        assert torch.equal(xor_scan.xor_gather(db4, off2, k), want), bad


def test_xor_gather_routes_cpu_to_plain():
    rng = np.random.default_rng(4)
    db4 = from_u32(_db(rng, 2, 1, 4, 1))
    off = torch.zeros((1, 2, 2), dtype=torch.int32)
    launches = xor_scan.xor_gather_cuda.launches
    xor_scan.xor_gather(db4, off, 1)
    assert xor_scan.xor_gather_cuda.launches == launches
    with pytest.raises(ValueError):
        xor_scan.xor_gather_cuda(db4, off, 1)     # not a CUDA tensor


def test_port_imports_no_jax():
    """The port never loads jax: a fresh interpreter imports every module
    of the package and finds no jax in sys.modules."""
    code = ("import sys, pacmann_tpu_torch.private.fused_search, "
            "pacmann_tpu_torch.pir.convert, pacmann_tpu_torch.ops.aes, "
            "pacmann_tpu_torch.ops.protocol_kernels, "
            "pacmann_tpu_torch.ops.attic; "
            "assert 'jax' not in sys.modules, 'jax imported'")
    subprocess.run([sys.executable, "-c", code], check=True)
