"""The port's distances (ops/distance.py, the plain version of kernel K6)
against the JAX package's: l2_distance_xla, the Pallas kernel
l2_distance_pallas run in interpret mode, inner_product_xla and
l2_distance_single; and the dispatcher's routing of CPU tensors."""

import numpy as np
import pytest
import torch

from pacmann_tpu.ops import distance as jdist
from pacmann_tpu_torch.ops import distance
from pacmann_tpu_torch.utils import cuda_lib

# Tests run in several worker processes at once; one intra-op thread each
# (these tensors are small).
torch.set_num_threads(1)


def _float_pair(seed, Q, B, D):
    rng = np.random.default_rng(seed)
    return (rng.random((Q, D), dtype=np.float32),
            rng.random((B, D), dtype=np.float32))


def _int_pair(seed, Q, B, D):
    """Integer values 0-255 (SIFT's range): every partial sum is exact."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (Q, D)).astype(np.float32),
            rng.integers(0, 256, (B, D)).astype(np.float32))


def _plain(q, p):
    return distance.l2_distance_plain(torch.from_numpy(q),
                                      torch.from_numpy(p)).numpy()


@pytest.mark.parametrize("Q,B,D", [(37, 211, 128), (5, 9, 37)])
def test_l2_plain_matches_xla_on_floats(Q, B, D):
    q, p = _float_pair(Q, Q, B, D)
    got = _plain(q, p)
    want = np.asarray(jdist.l2_distance_xla(q, p))
    assert got.dtype == np.float32 and got.shape == (Q, B)
    assert np.allclose(got, want, rtol=1e-4, atol=1e-3)


def test_l2_plain_matches_pallas_interpret_on_floats():
    q, p = _float_pair(2, 17, 300, 96)
    got = _plain(q, p)
    want = np.asarray(jdist.l2_distance_pallas(q, p, tile_q=16, tile_b=128))
    assert np.allclose(got, want, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("D", [37, 128])
def test_l2_plain_bit_equal_to_xla_and_pallas_on_integers(D):
    """Integer-valued data, odd D too: bit-equal to both JAX forms."""
    q, p = _int_pair(D, 13, 150, D)
    got = _plain(q, p)
    assert np.array_equal(got, np.asarray(jdist.l2_distance_xla(q, p)))
    assert np.array_equal(got, np.asarray(jdist.l2_distance_pallas(
        q, p, tile_q=8, tile_b=128)))
    # the clamp: a point against itself is exactly 0
    assert np.all(_plain(p[:4], p[:4]).diagonal() == 0.0)


def test_inner_product_wraps_like_u32():
    rng = np.random.default_rng(3)
    a = rng.integers(0, 2**32, size=(8, 128), dtype=np.uint32)
    b = rng.integers(0, 2**32, size=(12, 128), dtype=np.uint32)
    got = distance.inner_product(a, b, device="cpu")
    assert got.dtype == torch.int32 and got.shape == (8, 12)
    want = (np.einsum("qd,bd->qb", a.astype(np.uint64), b.astype(np.uint64))
            & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    assert np.array_equal(got.numpy().view(np.uint32), want)
    assert np.array_equal(got.numpy(),
                          np.asarray(jdist.inner_product_xla(a, b)))


def test_l2_single_matches_jax():
    rng = np.random.default_rng(4)
    a = rng.random(128, dtype=np.float32)
    b = rng.random(128, dtype=np.float32)
    got = float(distance.l2_distance_single(a, b, device="cpu"))
    assert np.isclose(got, float(jdist.l2_distance_single(a, b)), rtol=1e-5)
    ai, bi = (rng.integers(0, 256, 128).astype(np.float32) for _ in range(2))
    assert float(distance.l2_distance_single(ai, bi, device="cpu")) \
        == float(jdist.l2_distance_single(ai, bi))


@pytest.mark.parametrize("use_pallas", [None, True, False])
def test_dispatcher_routes_cpu_to_plain(monkeypatch, use_pallas):
    """A CPU tensor takes the plain version whatever use_pallas says: the
    kernel is never built or counted."""
    def no_cuda(*a, **k):
        raise AssertionError("cuda_lib reached with CPU tensors")

    monkeypatch.setattr(cuda_lib, "load", no_cuda)
    monkeypatch.setattr(cuda_lib, "function", no_cuda)
    q, p = _int_pair(5, 6, 40, 24)
    launches = distance.l2_distance_cuda.launches
    got = distance.l2_distance(torch.from_numpy(q), torch.from_numpy(p),
                               use_pallas=use_pallas)
    assert torch.equal(got, torch.from_numpy(_plain(q, p)))
    assert distance.l2_distance_cuda.launches == launches
    with pytest.raises(ValueError):
        distance.l2_distance_cuda(torch.from_numpy(q), torch.from_numpy(p))
    assert distance.l2_distance_cuda.launches == launches


def test_build_digest_covers_included_headers(monkeypatch, tmp_path):
    """K2 and K6 include csrc/cp_async.cuh: editing a header renames the
    build, so a stale library is never loaded."""
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(cuda_lib, "CSRC", tmp_path)
    before = cuda_lib.source_digest(tmp_path / "k.cu")
    (tmp_path / "h.cuh").write_text("// two\n")
    assert cuda_lib.source_digest(tmp_path / "k.cu") != before


def test_package_sources_include_only_package_headers():
    """Every header a kernel source includes by name lies in csrc/."""
    import re
    from pathlib import Path
    csrc = Path(distance.__file__).resolve().parent.parent / "csrc"
    for src in csrc.glob("*.cu"):
        for name in re.findall(r'#include "([^"]+)"', src.read_text()):
            assert (csrc / name).exists(), (src.name, name)
