"""The port's attic (pacmann_tpu_torch/ops/attic.py, plain versions of
kernels K7a-K7d) bit for bit against the JAX package's attic functions,
which run their Pallas kernels in interpret mode on the CPU, as the JAX
package's own tests run them. Inputs come from numpy seeds."""

import numpy as np
import pytest
import torch

from pacmann_tpu.ops import attic as jattic
from pacmann_tpu.ops.xor_scan import xor_scan_np, xor_scan_parts
from pacmann_tpu_torch.ops import attic
from pacmann_tpu_torch.utils import cuda_lib
from pacmann_tpu_torch.utils.u32 import to_u32

# Tests run in several worker processes at once; torch's default of one
# intra-op thread per core oversubscribes the machine, and these tensors
# are small.
torch.set_num_threads(1)


def _u32(rng, *shape):
    return rng.integers(0, 2**32, size=shape, dtype=np.uint32)


@pytest.mark.parametrize("k", [2, 5])
def test_xor_scan_pallas_matches_jax(k):
    """K7c: the twin of test_pallas_xor_scan_interpret (S=4, C=8, B=16,
    block_b=8), and the same at k = 5."""
    rng = np.random.default_rng(2 + k)
    S, C, B = 4, 8, 16
    db = _u32(rng, S, C * k, 128)
    off = rng.integers(0, C, size=(B, S), dtype=np.uint32)
    skip = rng.random((B, S)) < 0.2
    want = np.asarray(jattic.xor_scan_pallas(db, off, skip, k, block_b=8))
    got = attic.xor_scan_pallas(db, off, skip, k, block_b=8, device="cpu")
    assert got.shape == (B, k, 128)
    assert np.array_equal(to_u32(got), want)
    assert np.array_equal(want, xor_scan_np(db, off, skip, k))


@pytest.mark.parametrize("k", [2, 5])
def test_xor_hintgen_pallas_matches_jax(k):
    """K7b: the twin of test_pallas_hintgen_interpret (B = 19, not a
    multiple of the JAX block, which pads it), and the same at k = 5."""
    rng = np.random.default_rng(3 + k)
    S, P, C, B = 4, 2, 8, 19
    db4 = _u32(rng, S, P, C * k, 128)
    off = rng.integers(0, C, size=(P, B, S), dtype=np.uint32)
    skip = rng.random((P, B, S)) < 0.25
    want = np.asarray(jattic.xor_hintgen_pallas(db4, off, skip, k))
    got = attic.xor_hintgen_pallas(db4, off, skip, k, device="cpu")
    assert got.shape == (P, B, k, 128)
    assert np.array_equal(to_u32(got), want)
    assert np.array_equal(want, np.asarray(xor_scan_parts(db4, off, skip, k)))


def _plane_case(k, seed=11):
    rng = np.random.default_rng(seed)
    S, P, C, T = 6, 3, 16, 20
    db4 = _u32(rng, S, P, C * k, 128)
    table = rng.integers(0, C, size=(P, T, S), dtype=np.uint32)
    skip = rng.random((P, T, S)) < 0.3
    return db4, table, skip


@pytest.mark.parametrize("k", [2, 5])
def test_to_plane_major_s8_matches_jax(k):
    db4, _, _ = _plane_case(k)
    want = np.asarray(jattic.to_plane_major_s8(db4, k))
    got = attic.to_plane_major_s8(db4, k, device="cpu")
    assert got.dtype == torch.int8
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("k,sc", [(2, 1), (2, 2), (2, 3), (2, 6), (5, 3)])
def test_plane_major_s8_matches_jax(k, sc):
    """K7a: the twin of test_plane_major_s8_mm_matches_scan_oracle (every
    chunks-per-step sc that divides S = 6), and k = 5."""
    db4, table, skip = _plane_case(k)
    dbp_j = jattic.to_plane_major_s8(db4, k)
    want = np.asarray(jattic.xor_hintgen_mm_s8p(dbp_j, table, skip, k, sc=sc))
    dbp = attic.to_plane_major_s8(db4, k, device="cpu")
    got = attic.xor_hintgen_mm_s8p(dbp, table, skip, k, sc=sc, device="cpu")
    assert got.shape == (3, 20, k * 128)
    assert np.array_equal(to_u32(got), want)
    ref = np.asarray(xor_scan_parts(db4, table, skip, k)).reshape(want.shape)
    assert np.array_equal(want, ref)


def test_plane_major_s8_sc_must_divide_s():
    db4, table, skip = _plane_case(2)
    with pytest.raises(ValueError):
        jattic.xor_hintgen_mm_s8p(jattic.to_plane_major_s8(db4, 2), table,
                                  skip, 2, sc=4)
    with pytest.raises(ValueError):
        attic.xor_hintgen_mm_s8p(attic.to_plane_major_s8(db4, 2, "cpu"),
                                 table, skip, 2, sc=4, device="cpu")


def _refresh_case(rng, Q, P, Hp, Ep, duplicate=False):
    ppar = _u32(rng, P, Hp, Ep)
    new_par = _u32(rng, Q, P, Ep)
    # unique hit slots per partition (the claim invariant)
    hit = np.stack([rng.choice(Hp, size=Q, replace=False) for _ in range(P)],
                   axis=1).astype(np.int32)
    ok = rng.random((Q, P)) < 0.7
    if duplicate:
        # rounds repeating one slot: the last ok one wins
        hit[Q // 2:, 0] = hit[0, 0]
        ok[-1, 0] = False
        ok[-2, 0] = True
    return ppar, new_par, hit, ok


@pytest.mark.parametrize("Q,P,Hp,Ep,duplicate", [
    (16, 4, 480, 128, False), (8, 2, 896, 256, False),
    (12, 3, 64, 128, False), (12, 3, 64, 128, True)])
def test_refresh_parity_matches_jax_and_numpy_twin(Q, P, Hp, Ep, duplicate):
    """K7d: the twin of test_refresh_parity_matches_numpy_twin (its three
    shapes) and a case of repeated hit slots; the input stays unchanged."""
    rng = np.random.default_rng(9 + Q + duplicate)
    ppar, new_par, hit, ok = _refresh_case(rng, Q, P, Hp, Ep, duplicate)
    want = np.asarray(jattic.refresh_parity(ppar, new_par, hit, ok))
    assert np.array_equal(want, attic.refresh_parity_np(ppar, new_par, hit,
                                                         ok))
    t_ppar = torch.from_numpy(ppar.view(np.int32).copy())
    before = t_ppar.clone()
    got = attic.refresh_parity(t_ppar, new_par, hit, ok, device="cpu")
    assert np.array_equal(to_u32(got), want)
    assert torch.equal(t_ppar, before)
    if duplicate:
        last = np.flatnonzero(ok[:, 0] & (hit[:, 0] == hit[0, 0]))[-1]
        assert np.array_equal(want[0, hit[0, 0]], new_par[last, 0])


def test_attic_cpu_tensors_take_the_plain_versions(monkeypatch):
    """CPU input never reaches cuda_lib, the kernel wrappers refuse CPU
    tensors, and numpy input with no device goes to CUDA (raising here)."""
    def no_cuda(*a, **k):
        raise AssertionError("cuda_lib reached with CPU tensors")

    monkeypatch.setattr(cuda_lib, "load", no_cuda)
    monkeypatch.setattr(cuda_lib, "function", no_cuda)
    rng = np.random.default_rng(1)
    db = torch.from_numpy(_u32(rng, 2, 8, 128).view(np.int32))
    off = torch.zeros((3, 2), dtype=torch.int32)
    skip = torch.zeros((3, 2), dtype=torch.bool)
    counts = [f.launches for f in (
        attic.xor_hintgen_mm_s8p_cuda, attic.xor_hintgen_pallas_cuda,
        attic.xor_scan_pallas_cuda, attic.refresh_parity_cuda)]
    attic.xor_scan_pallas(db, off, skip, 1)
    attic.xor_hintgen_pallas(db[:, None], off[None], skip[None], 1)
    dbp = attic.to_plane_major_s8(db[:, None], 1)
    attic.xor_hintgen_mm_s8p(dbp, off[None], skip[None], 1)
    attic.refresh_parity(db, db[None, :, 0], off[:1], skip[:1])
    assert counts == [f.launches for f in (
        attic.xor_hintgen_mm_s8p_cuda, attic.xor_hintgen_pallas_cuda,
        attic.xor_scan_pallas_cuda, attic.refresh_parity_cuda)]
    for call in (lambda: attic.xor_scan_pallas_cuda(db, off, skip, 1),
                 lambda: attic.xor_hintgen_pallas_cuda(
                     db[:, None], off[None], skip[None], 1),
                 lambda: attic.xor_hintgen_mm_s8p_cuda(dbp, off[None]),
                 lambda: attic.refresh_parity_cuda(db, db[None, :, 0],
                                                   off[:1], skip[:1])):
        with pytest.raises(ValueError):
            call()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            attic.xor_scan_pallas(db.numpy(), off.numpy(), skip.numpy(), 1)


@pytest.mark.parametrize("k", [2, 3])
def test_xor_scan_pallas_ragged_matches_jax(k):
    """K7c at a ragged flat shape: C = 12 (no power of two), S = 7 (S % 4
    != 0), B = 37 (no multiple of the JAX block of 16, which pads it), a
    row that skips every chunk and one that skips none. Bit-equal (zero
    tolerance)."""
    rng = np.random.default_rng(40 + k)
    S, C, B = 7, 12, 37
    db = _u32(rng, S, C * k, 128)
    off = rng.integers(0, C, size=(B, S), dtype=np.uint32)
    skip = rng.random((B, S)) < 0.3
    skip[5] = True
    skip[6] = False
    want = np.asarray(jattic.xor_scan_pallas(db, off, skip, k, block_b=16))
    got = attic.xor_scan_pallas(db, off, skip, k, block_b=16, device="cpu")
    assert np.array_equal(to_u32(got), want)
    assert not want[5].any()
    assert np.array_equal(want, xor_scan_np(db, off, skip, k))


def test_plane_major_s8_ragged_hint_count_matches_jax():
    """K7a at T = 1,100 hints: no multiple of the JAX hint block (two blocks
    of 640, padded) nor of a staged CTA's 1,536; C = 12, S = 6. Bit-equal
    (zero tolerance)."""
    rng = np.random.default_rng(44)
    S, P, C, T, k = 6, 2, 12, 1100, 2
    db4 = _u32(rng, S, P, C * k, 128)
    table = rng.integers(0, C, size=(P, T, S), dtype=np.uint32)
    skip = rng.random((P, T, S)) < 0.3
    want = np.asarray(jattic.xor_hintgen_mm_s8p(
        jattic.to_plane_major_s8(db4, k), table, skip, k, sc=3))
    dbp = attic.to_plane_major_s8(db4, k, device="cpu")
    got = attic.xor_hintgen_mm_s8p(dbp, table, skip, k, sc=3, device="cpu")
    assert np.array_equal(to_u32(got), want)


_C7A, _C7C = attic.PLANE_STAGED_MAX_C, attic.FLAT_STAGED_MAX_C


@pytest.mark.parametrize("P,B,C,form", [
    (16, 16 * 512, 512, "staged"), (16, 16 * 512 - 1, 512, "row"),
    (16, 16 * _C7A + 16, _C7A + 1, "row"), (16, 12512, 512, "staged"),
    (1, 16 * 33, 33, "staged"), (16, 96, 512, "row")])
def test_plane_form_rule(P, B, C, form):
    """K7a's form by shape: staged from B = 16C up, C <= 512."""
    assert attic.plane_form(P, B, 124, C, 2) == form


_C7B = attic.HINTGEN_STAGED_MAX_C


@pytest.mark.parametrize("P,B,C,form", [
    (16, 16 * 512, 512, "staged"), (16, 16 * 512 - 1, 512, "row"),
    (16, 16 * _C7B + 16, _C7B + 1, "row"), (16, 12512, 512, "staged"),
    (16, 16 * 513, 513, "row"), (1, 16 * 33, 33, "staged"),
    (1, 16 * 33 - 1, 33, "row"), (16, 96, 512, "row"),
    (16, 35_552, 2048, "row")])
def test_hintgen_form_rule(P, B, C, form):
    """K7b's form by shape, K2's rule: staged from B = 16C up, C <= 512
    (the fused engine's prep at SIFT1M, (16, 12,512) at C = 512, is
    staged; the 5M shape's C = 2,048 is not)."""
    assert _C7B == 512
    assert attic.hintgen_form(P, B, 124, C, 2) == form


@pytest.mark.parametrize("B,C,form", [
    (20 * 2048, 2048, "staged"), (20 * 2048 - 1, 2048, "row"),
    (57_632, 2048, "staged"), (28_816, 2048, "row"),
    (20 * _C7C, _C7C, "staged"), (20 * _C7C + 20, _C7C + 1, "row"),
    (10**7, 65_534, "row"), (10**7, 65_535, "row"), (9001, 1000, "row"),
    (2000, 2048, "row")])
def test_flat_form_rule(B, C, form):
    """K7c's form by shape: staged from B = 20C up, C <= 3,072 (the ring's
    shared memory, well under the 16-bit row indices' C < 65,535)."""
    assert attic.flat_form(B, 492, C, 2) == form


def test_attic_forms_are_named():
    """A form other than "staged" or "row" is refused before any launch."""
    assert [attic._form_flag(f) for f in attic.FORMS] == [1, 0]
    with pytest.raises(ValueError):
        attic._form_flag("chunk")
