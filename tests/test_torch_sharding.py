"""The port's mesh sharding (pacmann_tpu_torch/parallel) against the JAX
package's, on meshes of CPU shards (["cpu"] * n) beside conftest's eight
virtual JAX devices: the chunk-sharded XOR scan, the row-sharded L2 top-k
(bit-exact on integer-valued data), the mesh rules, the dry run and
exact_search -shards. At a row count the shards do not divide, the JAX
CLI's +inf padding rows win its top-k; the port returns the true nearest
(a deliberate difference, pinned here on both sides)."""

import os
import re

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from pacmann_tpu.cli import exact_search as jexact
from pacmann_tpu.ops.xor_scan import xor_scan_np
from pacmann_tpu.parallel import sharding as jsh
from pacmann_tpu.pir import layout as jlayout
from pacmann_tpu_torch.cli import exact_search
from pacmann_tpu_torch.graph.recall import knn_search
from pacmann_tpu_torch.parallel import sharding
from pacmann_tpu_torch.parallel.dryrun import dryrun_multichip
from pacmann_tpu_torch.utils.u32 import from_u32, to_u32

torch.set_num_threads(1)

FIX = os.path.join(os.path.dirname(__file__), "fixtures")


def _cpu_mesh(n):
    return sharding.make_mesh(devices=["cpu"] * n)


def _rows_sharded(mesh, x):
    return jax.device_put(x, NamedSharding(mesh, PartitionSpec("shard", None)))


@pytest.mark.parametrize("n_dev", [8, 4])
def test_sharded_xor_scan_matches_reference(n_dev):
    """A ragged DB (zero padding rows) and 10 % skip: the port's scan equals
    JAX's sharded_xor_scan and xor_scan_np bit for bit."""
    rng = np.random.default_rng(0)
    chunk_size, set_size, entry_u32 = 16, 32, 4
    raw = rng.integers(0, 2**32, size=(chunk_size * set_size - 5, entry_u32),
                       dtype=np.uint32)
    packed = jlayout.pack_db(raw, chunk_size, set_size)
    k = jlayout.entry_rows(entry_u32)
    B = 24
    offsets = rng.integers(0, chunk_size, size=(B, set_size),
                           dtype=np.uint32)
    skip = rng.random((B, set_size)) < 0.1
    jmesh = jsh.make_mesh(n_dev)
    want = np.asarray(jsh.sharded_xor_scan(
        jmesh, jsh.shard_db(jmesh, packed), jsh.replicate(jmesh, offsets),
        jsh.replicate(jmesh, skip), k))
    assert np.array_equal(want, xor_scan_np(packed, offsets, skip, k))
    mesh = _cpu_mesh(n_dev)
    got = sharding.sharded_xor_scan(
        mesh, sharding.shard_db(mesh, from_u32(packed)),
        sharding.replicate(mesh, from_u32(offsets)),
        torch.from_numpy(skip), k)
    assert got.shape == (B, k, 128)
    assert np.array_equal(to_u32(got), want)


@pytest.mark.parametrize("n_dev", [8, 4])
def test_sharded_l2_topk_matches_reference(n_dev):
    """Integer-valued vectors (exact f32 distances, many ties) with N % 8 ==
    0: ids and distances equal JAX's sharded_l2_topk (ties to the lower
    global id) and the single-device knn_search."""
    rng = np.random.default_rng(1)
    N, D, Q, K = 512, 16, 6, 10
    vectors = rng.integers(0, 4, size=(N, D)).astype(np.float32)
    queries = rng.integers(0, 4, size=(Q, D)).astype(np.float32)
    jmesh = jsh.make_mesh(n_dev)
    j_ids, j_d = jsh.sharded_l2_topk(jmesh, jsh.replicate(jmesh, queries),
                                     _rows_sharded(jmesh, vectors), K)
    mesh = _cpu_mesh(n_dev)
    v, q = torch.from_numpy(vectors), torch.from_numpy(queries)
    ids, d = sharding.sharded_l2_topk(
        mesh, sharding.replicate(mesh, q), sharding.shard_db(mesh, v), K)
    assert np.array_equal(ids.numpy(), np.asarray(j_ids))
    assert np.array_equal(d.numpy(), np.asarray(j_d))
    want_d, want_ids = knn_search(v, q, K)
    assert torch.equal(ids, want_ids) and torch.equal(d, want_d)


def test_ragged_rows_padding_fault_pinned():
    """n = 1,001 over 4 shards. The reference CLI pads the rows with +inf
    up to a multiple of the shards (cli/exact_search.py:51-54); its
    distance turns a padded row into inf - inf = NaN, and lax.top_k ranks
    NaN first, so ids 1001-1003, rows that do not exist, lead every query.
    The port shards the rows unevenly (no padding) and equals knn_search."""
    rng = np.random.default_rng(2)
    n, D, Q, K = 1001, 8, 3, 5
    vectors = rng.random((n, D), dtype=np.float32)
    queries = rng.random((Q, D), dtype=np.float32)
    padded = np.pad(vectors, ((0, 3), (0, 0)), constant_values=np.inf)
    jmesh = jsh.make_mesh(4)
    j_ids, _ = jsh.sharded_l2_topk(jmesh, jsh.replicate(jmesh, queries),
                                   _rows_sharded(jmesh, padded), K)
    j_ids = np.asarray(j_ids)
    assert (np.sort(j_ids[:, :3], axis=1) == [1001, 1002, 1003]).all()
    mesh = _cpu_mesh(4)
    v, q = torch.from_numpy(vectors), torch.from_numpy(queries)
    shards = sharding.shard_rows(mesh, v)
    assert [s.shape[0] for s in shards] == [251, 250, 250, 250]
    ids, d = sharding.sharded_l2_topk(mesh, q, shards, K)
    want_d, want_ids = knn_search(v, q, K)
    assert torch.equal(ids, want_ids) and torch.equal(d, want_d)
    assert int(ids.max()) < n


def test_make_mesh_rules(monkeypatch):
    """Explicit devices may repeat and are cut to n_devices; a mesh says
    how many distinct devices it spans; without devices it needs CUDA."""
    mesh = sharding.make_mesh(devices=["cpu"] * 4)
    assert mesh.size == 4
    assert mesh.distinct == (torch.device("cpu"),)
    assert mesh.describe() == "4 shards on 1 device(s)"
    assert sharding.make_mesh(3, devices=["cpu"] * 8).size == 3
    with pytest.raises(ValueError):
        sharding.make_mesh(5, devices=["cpu"] * 4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        sharding.make_mesh(2)
    with pytest.raises(ValueError, match="divisible"):
        sharding.shard_db(mesh, torch.zeros(6, 2))


def test_xor_allreduce_folds_partials():
    rng = np.random.default_rng(3)
    parts = [rng.integers(0, 2**32, size=(5, 7), dtype=np.uint32)
             for _ in range(3)]
    got = sharding.xor_allreduce([from_u32(p) for p in parts])
    assert np.array_equal(to_u32(got), parts[0] ^ parts[1] ^ parts[2])


def test_dryrun_multichip_passes():
    dryrun_multichip(8, devices=["cpu"] * 8)


def _recall(out):
    return re.search(r"Recall@10: ([0-9.]+)", out).group(1)


def test_exact_search_shards_matches_jax(capsys):
    """-shards 4 on the fixtures (n = 256, divisible by 4), the mesh given
    as devices=: the recall line equals the JAX CLI's and the
    single-device run's."""
    argv = ["-n", "256", "-d", "128", "-k", "10", "-q", "8", "-input",
            os.path.join(FIX, "mini_base.bvecs"), "-query",
            os.path.join(FIX, "mini_query.fvecs"), "-gnd",
            os.path.join(FIX, "mini_gnd.ivecs")]
    assert exact_search.main(argv + ["-shards", "4"],
                             devices=["cpu"] * 4) == 0
    out = capsys.readouterr().out
    assert "over 4 shards on 1 device(s)" in out
    got = _recall(out)
    assert jexact.main(argv + ["-shards", "4"]) == 0
    assert _recall(capsys.readouterr().out) == got
    assert exact_search.main(argv, device="cpu") == 0
    assert _recall(capsys.readouterr().out) == got == "1.0000"
