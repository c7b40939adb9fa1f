"""The port's host tier (pacmann_tpu_torch/native_lib.py over
csrc/host/pacmann_native.cpp) against the port's plain torch versions and
the JAX package's numpy path: every entry point bit-exact on integers
(ragged T, S and B, k = 1, 2, 5, skips, offsets outside [0, C)), l2_batch
within 1e-5 relative. Then each engine that takes the host tier on the
CPU (PianoPIR, SimpleBatchPianoPIR, FusedBatchPianoPIR, DevicePianoEngine)
with the library on and with it turned off: both bit-equal in state and
answers to the JAX engine, the call counters showing which route ran."""

import dataclasses
import secrets
import subprocess
import sys

import numpy as np
import pytest
import torch

from pacmann_tpu.ops import aes_host as jax_aes_host
from pacmann_tpu.ops.xor_scan import xor_scan_np
from pacmann_tpu.pir.batch import SimpleBatchPianoPIR as JaxSimple
from pacmann_tpu.pir.device_engine import DevicePianoEngine as JaxDevice
from pacmann_tpu.pir.engine import FusedBatchPianoPIR as JaxFused
from pacmann_tpu.pir.piano import PianoPIR as JaxPIR
from pacmann_tpu_torch import native_lib
from pacmann_tpu_torch.ops import aes, aes_host, attic, distance, xor_scan
from pacmann_tpu_torch.pir.batch import SimpleBatchPianoPIR
from pacmann_tpu_torch.pir.convert import state_to_numpy
from pacmann_tpu_torch.pir.device_engine import DevicePianoEngine
from pacmann_tpu_torch.pir.engine import FusedBatchPianoPIR
from pacmann_tpu_torch.pir.piano import PianoPIR
from pacmann_tpu_torch.utils import cuda_lib

torch.set_num_threads(1)


@pytest.fixture
def calls():
    """The library (built on first use: the tests' machine has g++ and a
    CPU with AES-NI, AVX2 and FMA) with its call counters from zero."""
    assert native_lib.available(), "the host library did not build or load"
    native_lib.reset_calls()
    return lambda: {fn.__name__: fn.calls for fn in native_lib.ENTRY_POINTS}


def _u32(rng, *shape):
    return rng.integers(0, 2**32, size=shape, dtype=np.uint32)


def test_builds_from_the_port_source_into_its_build_dir(calls):
    """The library is the port's own build of csrc/host/, named by the
    source's hash; the JAX package's native/ library is not loaded."""
    src = cuda_lib.HOST_CSRC / "pacmann_native.cpp"
    want = cuda_lib.BUILD / (f"libpacmann_native-"
                             f"{cuda_lib.source_digest(src)}.so")
    assert native_lib.load()._name == str(want) and want.exists()
    assert native_lib.host_route("cpu") and native_lib.host_route(
        torch.device("cpu"))
    assert not native_lib.host_route("cuda") \
        and not native_lib.host_route(torch.device("cuda", 0))


def test_expand_key_matches_the_key_schedule(calls):
    for seed in range(4):
        key = np.random.default_rng(seed).bytes(16)
        got = native_lib.expand_key(key)
        assert got.dtype == np.uint8 and got.shape == (176,)
        assert np.array_equal(got, aes_host.expand_key(key).reshape(-1))
        assert np.array_equal(got, jax_aes_host.expand_key(key).reshape(-1))
    assert calls()["expand_key"] == 4
    with pytest.raises(ValueError):
        native_lib.expand_key(b"short")


@pytest.mark.parametrize("n", [1, 7, 8, 9, 1001])
def test_prf_eval_u64_matches_numpy_and_plain(calls, n):
    """Full u64 against the JAX numpy oracle (any tag, x < 2^32); the
    masked low word against the plain K5 version (tags < 2^29, its
    contract)."""
    rng = np.random.default_rng(n)
    key = rng.bytes(16)
    rk = native_lib.expand_key(key)
    tags = rng.integers(0, 2**29, size=n, dtype=np.uint64)
    tags[::3] = rng.integers(2**29, 2**40, size=tags[::3].size,
                             dtype=np.uint64)
    xs = rng.integers(0, 2**32, size=n, dtype=np.uint64)
    got = native_lib.prf_eval_u64(rk, tags, xs)
    assert got.dtype == np.uint64 and got.shape == (n,)
    assert np.array_equal(got, jax_aes_host.prf_eval_u64(
        jax_aes_host.expand_key(key), tags, xs))
    assert np.array_equal(got, aes_host.prf_eval_u64(aes_host.expand_key(key),
                                                     tags, xs))
    low = tags < 2**29
    mask = 0xFFFFF
    plain = aes.prf_eval_plain(
        torch.from_numpy(aes_host.expand_key(key)[None]),
        torch.from_numpy(tags[low].astype(np.int32)[None]),
        torch.from_numpy(xs[low].astype(np.uint32).view(np.int32)[None]),
        mask)[0].numpy()
    assert np.array_equal(got[low] & np.uint64(mask), plain.astype(np.uint64))
    # broadcasting, as the reference's wrapper takes it
    grid = native_lib.prf_eval_u64(rk, tags[:, None], xs[None, :4])
    assert grid.shape == (n, min(n, 4))
    assert np.array_equal(grid[:, 0], native_lib.prf_eval_u64(
        rk, tags, np.full(n, xs[0])))
    assert calls()["prf_eval_u64"] == 3


@pytest.mark.parametrize("T,S,mask", [(1, 1, 31), (13, 7, 1000),
                                      (100, 9, 0xFFFF), (257, 300, 2047),
                                      (12, 8, 0xFFFFFFFF)])
def test_prf_offset_table_matches_numpy_and_plain(calls, T, S, mask):
    """Ragged T and S (not multiples of the kernel's 8 blocks in flight)
    and masks that are no power of two, against K1's plain version and
    the JAX numpy oracle; tag0 > 0 against the oracle."""
    key = np.random.default_rng(T * S).bytes(16)
    rk = native_lib.expand_key(key)
    got = native_lib.prf_offset_table(rk, 0, T, S, mask)
    assert got.dtype == np.uint32 and got.shape == (T, S)
    plain = aes.prf_tables_plain(aes.round_keys([key]), T, S, mask)[0]
    assert np.array_equal(got, plain.numpy().view(np.uint32))
    tags = np.arange(T, dtype=np.uint64)[:, None]
    xs = np.arange(S, dtype=np.uint64)[None, :]
    for tag0 in (0, 5000):
        want = (jax_aes_host.prf_eval_u64(jax_aes_host.expand_key(key),
                                          tags + np.uint64(tag0), xs)
                & np.uint64(mask)).astype(np.uint32)
        assert np.array_equal(
            native_lib.prf_offset_table(rk, tag0, T, S, mask), want)
    # the engines' table: one native table a partition, fresh int32
    rks = aes.round_keys([key, key[::-1]])
    tables = aes.prf_tables_native(rks, T, S, mask)
    assert tables.dtype == torch.int32 and tables.shape == (2, T, S)
    assert torch.equal(tables, aes.prf_tables_plain(rks, T, S, mask))
    assert calls()["prf_offset_table"] == 5


@pytest.mark.parametrize("k,S,C,B", [(1, 3, 5, 1), (2, 7, 12, 33),
                                     (5, 4, 9, 10), (2, 13, 16, 200)])
def test_xor_scan_matches_numpy_and_plain(calls, k, S, C, B):
    """Ragged S, C and B, k = 1, 2, 5, a quarter of the positions skipped
    and one all-skip row, against xor_scan_np (JAX) and K7c's plain
    version; offsets outside [0, C) that no skip covers read nothing, as
    the plain version's contract says."""
    rng = np.random.default_rng(k * 1000 + B)
    db = _u32(rng, S, C * k, 128)
    off = rng.integers(0, C, size=(B, S), dtype=np.uint32)
    skip = rng.random((B, S)) < 0.25
    skip[0] = True
    got = native_lib.xor_scan(db, off, skip, k)
    assert got.dtype == np.uint32 and got.shape == (B, k, 128)
    assert np.array_equal(got, xor_scan_np(db, off, skip, k))
    assert not got[0].any()
    plain = attic.xor_scan_pallas(db, off, skip, k, device="cpu")
    assert np.array_equal(got, plain.numpy().view(np.uint32))
    # outside [0, C): a skip on both sides
    wild = off.copy()
    wild[:, 0] = C + 3
    wild[-1, -1] = 2**32 - 1
    assert np.array_equal(
        native_lib.xor_scan(db, wild, skip, k),
        attic.xor_scan_pallas(db, wild, skip, k,
                              device="cpu").numpy().view(np.uint32))
    assert calls()["xor_scan"] == 2


def test_xor_scan_reads_in_place_and_returns_fresh(calls):
    """The engines hand the DB in as a read-only view of a live CPU
    tensor: it is read in place (no copy is needed to pass it), left as it
    was, and the answer is a fresh array that aliases none of it."""
    rng = np.random.default_rng(5)
    db = torch.from_numpy(_u32(rng, 4, 16, 128).view(np.int32))
    before = db.clone()
    off = torch.from_numpy(rng.integers(0, 8, size=(6, 4), dtype=np.int32))
    skip = torch.zeros((6, 4), dtype=torch.bool)
    got = xor_scan.xor_scan_native(db, off, skip, 2)
    assert torch.equal(db, before)
    assert got.dtype == torch.int32 and got.shape == (6, 2, 128)
    assert not np.shares_memory(got.numpy(), db.numpy())
    want = attic.xor_scan_pallas(db, off, skip, 2)
    assert torch.equal(got, want)
    view = db.numpy()
    view.flags.writeable = False
    assert np.array_equal(native_lib.xor_scan(view, off.numpy(),
                                              skip.numpy(), 2),
                          want.numpy().view(np.uint32))
    with pytest.raises(ValueError):
        native_lib.xor_scan(view, off.numpy()[:, :3], skip.numpy(), 2)
    with pytest.raises(ValueError):
        xor_scan.xor_scan_native(db.to("meta"), off, skip, 2)


@pytest.mark.parametrize("nq,nb,d", [(1, 1, 1), (5, 33, 7), (17, 64, 128),
                                     (3, 10, 37)])
def test_l2_batch_matches_plain(calls, nq, nb, d):
    rng = np.random.default_rng(nq * nb + d)
    q = rng.standard_normal((nq, d)).astype(np.float32)
    p = rng.standard_normal((nb, d)).astype(np.float32)
    got = native_lib.l2_batch(q, p)
    assert got.dtype == np.float32 and got.shape == (nq, nb)
    want = distance.l2_distance_plain(q, p, device="cpu").numpy()
    exact = ((q[:, None, :].astype(np.float64) - p[None]) ** 2).sum(-1)
    assert np.allclose(got, want, rtol=1e-5, atol=1e-5 * (1 + exact.max()))
    assert np.allclose(got, exact, rtol=1e-5, atol=1e-6)
    # integer-valued data: every f32 product and sum is exact
    qi = rng.integers(0, 16, size=(nq, d)).astype(np.float32)
    pi = rng.integers(0, 16, size=(nb, d)).astype(np.float32)
    assert np.array_equal(native_lib.l2_batch(qi, pi),
                          distance.l2_distance_plain(qi, pi,
                                                     device="cpu").numpy())
    assert calls()["l2_batch"] == 2


def test_inner_product_u32_wraps(calls):
    rng = np.random.default_rng(9)
    a = _u32(rng, 6, 19)
    b = _u32(rng, 4, 19)
    got = native_lib.inner_product_u32(a, b)
    want = (a.astype(np.uint64)[:, None, :] * b.astype(np.uint64)[None]
            ).sum(-1, dtype=np.uint64) & np.uint64(0xFFFFFFFF)
    assert got.dtype == np.uint32 and np.array_equal(got, want)
    port = distance.inner_product(a, b, device="cpu").numpy()
    assert np.array_equal(got, port.astype(np.int64).astype(np.uint32))
    assert calls()["inner_product_u32"] == 1


# ---------------------------------------------------------------------------
# the engines on device="cpu": host tier on and off, against JAX


@pytest.fixture(params=["native", "plain"])
def route(request, monkeypatch, calls):
    """Run the engine with the host library ("native") or with it turned
    off ("plain": available() False, as on a machine without a compiler)."""
    if request.param == "plain":
        monkeypatch.setattr(native_lib, "available", lambda: False)
    return request.param, calls


def _client_equal(r, g):
    for f in dataclasses.fields(r.state):
        want, have = getattr(r.state, f.name), getattr(g.state, f.name)
        assert np.array_equal(have, want), f.name
    assert sorted(g.cache) == sorted(r.cache)
    assert g._rng.bit_generator.state == r._rng.bit_generator.state


def _expect(route, got, used):
    """The counters: the named entry points ran (native) or none did."""
    name, calls = route
    seen = {k: v for k, v in calls().items() if v}
    if name == "plain":
        assert seen == {}
    else:
        assert set(seen) == set(used), seen


def test_piano_pir_host_tier(route):
    raw = _u32(np.random.default_rng(11), 4096, 8)
    ref = JaxPIR(4096, 32, raw, failure_prob_log2=8, device=False)
    got = PianoPIR(4096, 32, raw, failure_prob_log2=8, device="cpu")
    ref.preprocessing(rng=np.random.default_rng(12))
    got.preprocessing(rng=np.random.default_rng(12))
    _client_equal(ref.client, got.client)
    _expect(route, got, {"prf_offset_table", "xor_scan"})
    for idx in (3, 77, 4095, 3):
        assert np.array_equal(got.query(idx), ref.query(idx))
        _client_equal(ref.client, got.client)
    got.query(9, real=False)
    ref.query(9, real=False)
    _client_equal(ref.client, got.client)
    # the server's batch answer (a skip row included)
    off = np.random.default_rng(13).integers(
        0, got.params.chunk_size, size=(5, got.params.set_size),
        dtype=np.uint32)
    skip = np.zeros(off.shape, bool)
    skip[2] = True
    assert np.array_equal(got.server.private_query_batch(off, skip),
                          ref.server.private_query_batch(off, skip))


def test_piano_client_table_on_cpu_beside_card_scans(route, monkeypatch):
    """use_device_prep=False evaluates the client's table on the CPU: the
    host tier's AES-NI table where it is available."""
    raw = _u32(np.random.default_rng(14), 2048, 8)
    ref = JaxPIR(2048, 32, raw, failure_prob_log2=8, device=False)
    got = PianoPIR(2048, 32, raw, failure_prob_log2=8, device="cpu",
                   use_device_prep=False)
    ref.preprocessing(rng=np.random.default_rng(15))
    got.preprocessing(rng=np.random.default_rng(15))
    _client_equal(ref.client, got.client)
    _expect(route, got, {"prf_offset_table", "xor_scan"})


def test_simple_batch_host_tier(route, fixed_randbits):
    raw = _u32(np.random.default_rng(16), 8192, 8)
    ref = JaxSimple(8192, 32, 32, raw, 20, device=False)
    got = SimpleBatchPianoPIR(8192, 32, 32, raw, 20, device="cpu")
    ref.preprocessing(rng=np.random.default_rng(17))
    got.preprocessing(rng=np.random.default_rng(17))
    for r, g in zip(ref.sub_pir, got.sub_pir):
        _client_equal(r.client, g.client)
    _expect(route, got, {"prf_offset_table", "xor_scan"})
    rng = np.random.default_rng(18)
    for _ in range(3):
        ids = [int(i) for i in rng.integers(0, 8192, 32)]
        assert np.array_equal(got.query(ids), ref.query(ids))
    for r, g in zip(ref.sub_pir, got.sub_pir):
        _client_equal(r.client, g.client)


@pytest.fixture
def fixed_randbits(monkeypatch):
    """A re-prep draws a fresh key from secrets.randbits in both
    packages: pin it, so that both draw the same."""
    monkeypatch.setattr(secrets, "randbits", lambda k: 4242)


def test_fused_batch_host_tier(route, fixed_randbits):
    raw = _u32(np.random.default_rng(19), 8000, 8)
    ref = JaxFused(8000, 32, 32, raw, 20, device=False)
    got = FusedBatchPianoPIR(8000, 32, 32, raw, 20, device="cpu")
    ref.preprocessing(rng=np.random.default_rng(20))
    got.preprocessing(rng=np.random.default_rng(20))
    for r, g in zip(ref.clients, got.clients):
        _client_equal(r, g)
    _expect(route, got, {"prf_offset_table", "xor_scan"})
    rng = np.random.default_rng(21)
    for ids in ([int(i) for i in rng.integers(0, 8000, 32)],
                list(range(0, 8000, 250)), [5] * 32, [1, 2, 3]):
        assert np.array_equal(got.query(ids), ref.query(ids))
        for r, g in zip(ref.clients, got.clients):
            _client_equal(r, g)
    assert got.queries_made_in_partition == ref.queries_made_in_partition


def test_device_engine_host_tier(route):
    """The engine's (P, T, S) table on device="cpu" is the host tier's
    (the JAX engine's CPU backends); its scans stay the plain K2."""
    raw = _u32(np.random.default_rng(22), 8192, 8)
    ref = JaxDevice(8192, 32, 32, raw, 20)
    got = DevicePianoEngine(8192, 32, 32, raw, 20, device="cpu")
    ref.preprocessing(rng=np.random.default_rng(23))
    got.preprocessing(rng=np.random.default_rng(23))
    _expect(route, got, {"prf_offset_table"})
    rng = np.random.default_rng(24)
    for _ in range(2):
        ids = [int(i) for i in rng.integers(0, 8192, 96)]
        assert np.array_equal(got.query(ids), ref.query(ids))
    want = {k: np.asarray(v).astype(np.uint32) for k, v in ref.state.items()}
    have = state_to_numpy(got.state)
    assert set(have) == set(want)
    for key in want:
        assert np.array_equal(have[key], want[key]), key


def test_port_imports_no_jax_in_host_tier_and_scripts():
    """native_lib and the three scale scripts import neither jax nor the
    JAX package, in a fresh interpreter."""
    code = ("import sys, pacmann_tpu_torch.native_lib, "
            "pacmann_tpu_torch.scripts.e2e_scale, "
            "pacmann_tpu_torch.scripts.baselines_scale, "
            "pacmann_tpu_torch.scripts.plan_100m; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'pacmann_tpu' or "
            "m.startswith('pacmann_tpu.')]; assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True)
