"""The port's PRF offset tables (plain version of kernel K1) against the
JAX package: bit-equal to prf_tables_bytefirst_xla (the Pallas kernel's
XLA twin), to the host AES oracle, and to FIPS-197."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pacmann_tpu.ops import aes as jax_aes
from pacmann_tpu.ops.aes_pallas import prf_tables_bytefirst_xla
from pacmann_tpu_torch.ops import aes, aes_host

# Tests run in several worker processes at once; torch's default of one
# intra-op thread per core oversubscribes the machine (measured about
# 4x slower for this file set), and these tensors are small.
torch.set_num_threads(1)


def test_fips197_vector():
    """FIPS-197 appendix C.1 through the port's host oracle and through
    the plain torch rounds that the PRF tables use."""
    key = bytes(range(16))
    pt = np.frombuffer(bytes.fromhex("00112233445566778899aabbccddeeff"),
                       np.uint8)
    want = bytes.fromhex("69c4e0d86a7b0430d8cdb78070b4c55a")
    rk = aes_host.expand_key(key)
    assert aes_host.aes128_encrypt(rk, pt).tobytes() == want
    got = aes.encrypt_blocks(aes.round_keys([key])[0],
                             torch.from_numpy(pt.copy())[None, :])
    assert bytes(got[0].to(torch.uint8).tolist()) == want


def test_key_schedule_matches_reference():
    from pacmann_tpu.ops.aes_host import expand_key as ref_expand

    key = np.random.default_rng(3).bytes(16)
    assert np.array_equal(aes_host.expand_key(key), ref_expand(key))


# the lattice's varying bytes: s past its first byte (S > 256, a mask that
# is no power of two), and t << 3 into the block's third byte (T > 2^13)
@pytest.mark.parametrize("T,S,cm", [(40, 12, 31), (17, 8, 0xFFFFFFFF),
                                    (3, 300, 1000), (8200, 2, 0x7FF)])
def test_plain_tables_match_xla_twin_and_host(T, S, cm):
    rng = np.random.default_rng(T)
    keys = [rng.bytes(16) for _ in range(2)]
    got = aes.prf_tables_plain(aes.round_keys(keys), T, S, cm)
    got = got.numpy().view(np.uint32)
    masks = jnp.asarray(np.stack([jax_aes.expand_key_planes(k)
                                  for k in keys]))
    twin = np.asarray(prf_tables_bytefirst_xla(masks, T, S, cm))
    host = np.stack([
        (aes_host.prf_eval_u64(aes_host.expand_key(k),
                               np.arange(T, dtype=np.uint64)[:, None],
                               np.arange(S, dtype=np.uint64)[None, :])
         & np.uint64(cm)).astype(np.uint32) for k in keys])
    assert got.shape == (2, T, S)
    assert np.array_equal(got, twin)
    assert np.array_equal(got, host)


def test_plain_tables_span_blocks(monkeypatch):
    """The plain version walks the lattice in blocks; seams and the
    ragged tail must not change a value."""
    rng = np.random.default_rng(8)
    keys = [rng.bytes(16)]
    T, S, cm = 23, 7, 63
    want = aes.prf_tables_plain(aes.round_keys(keys), T, S, cm)
    monkeypatch.setattr(aes, "_PLAIN_BLOCK", 50)
    got = aes.prf_tables_plain(aes.round_keys(keys), T, S, cm)
    assert np.array_equal(got.numpy(), want.numpy())


def test_prf_tables_routes_cpu_to_plain():
    keys = [bytes(16), bytes(range(16))]
    rk = aes.round_keys(keys)
    launches = aes.aes_mmo_cuda.launches
    assert np.array_equal(aes.prf_tables(rk, 9, 4, 15).numpy(),
                          aes.prf_tables_plain(rk, 9, 4, 15).numpy())
    assert aes.aes_mmo_cuda.launches == launches
    with pytest.raises(ValueError):
        aes.aes_mmo_cuda(rk, 9, 4, 15)      # not a CUDA tensor
