"""pacmann_tpu_torch.bench (run as bench_torch.py) against the JAX
package's bench.py and scripts/verify_prep.py, on the CPU: the synthetic
DB bit for bit, every metric name and extra key of bench.py's three modes,
the prep checksum against the JAX engine's from the same seeds, the
device-only step loop against the fused search, the linear scan's product
against JAX's inner_product_xla, and an import that loads no JAX."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as jax_bench
from pacmann_tpu.ops.distance import inner_product_xla
from pacmann_tpu.pir.device_engine import DevicePianoEngine as JaxEngine
from pacmann_tpu_torch import bench
from pacmann_tpu_torch.graph.beam import finish_topk
from pacmann_tpu_torch.pir.convert import state_to_numpy
from pacmann_tpu_torch.pir.device_engine import DevicePianoEngine
from pacmann_tpu_torch.pir.params import expected_success_rate
from pacmann_tpu_torch.private import fused_search
from pacmann_tpu_torch.private.fused_search import FusedPrivateSearch
from pacmann_tpu_torch.private.oracle import pack_vertex_db

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


def _bench_py_lines() -> dict:
    """bench.py's printed JSON objects by function: (metric, extra keys),
    read from its source."""
    out = {}
    for fn in ast.parse((REPO / "bench.py").read_text()).body:
        if not isinstance(fn, ast.FunctionDef):
            continue
        for node in ast.walk(fn):
            if isinstance(node, ast.Dict) and any(
                    isinstance(k, ast.Constant) and k.value == "extra"
                    for k in node.keys):
                fields = dict(zip((k.value for k in node.keys), node.values))
                out[fn.name] = (fields["metric"].value,
                                {k.value for k in fields["extra"].keys})
    return out


BENCH_PY = _bench_py_lines()


@pytest.mark.parametrize("n,entry_u32,seed,float_cols,nbr_cols", [
    (1000, 160, 0, 128, 32),
    (20_000, 224, 3, 0, 0),         # crosses the 16,384-row block
    (5000, 8, 7, 4, 2),
])
def test_synth_raw_bit_identical(n, entry_u32, seed, float_cols, nbr_cols):
    want = jax_bench.synth_raw(n, entry_u32, seed, float_cols, nbr_cols)
    got = bench.synth_raw(n, entry_u32, seed, float_cols, nbr_cols)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_main_prints_bench_py_metric_and_keys(monkeypatch, capsys):
    """main(device="cpu") at n = 40,960, the smallest n whose budget (397 a
    partition) takes group 64's 384 sub-queries a step, with bench.py's
    iteration counts cut (the plain versions take seconds a prep on a
    CPU): bench.py's metric and every extra key, batch success 1.0."""
    monkeypatch.setenv("PACMANN_BENCH_N", "40960")
    for name, value in dict(STEPS=2, BATCH96_ITERS=2, GROUP1_REPS=1,
                            GROUP_REPS=1, G1_REPS=1).items():
        monkeypatch.setattr(bench, name, value)
    assert bench.main([], device="cpu") == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    metric, keys = BENCH_PY["main"]
    assert line["metric"] == metric and line["unit"] == "s"
    x = line["extra"]
    assert keys <= set(x), keys - set(x)
    assert x["n"] == 40960 and x["platform"] == "cpu"
    assert x["online_success_rate"] == 1.0
    assert x["protocol_route"] == "xla" and x["aes_route"] == "aes_mmo_tables"
    assert len(set(x["prep_checksums"])) == 3
    assert x["rows_exact_after_prep"] == "16/16"
    assert x["fused_group1_device_ids_valid"]
    assert line["vs_baseline"] == pytest.approx(
        2.64 * 0.04096 / line["value"], abs=6e-4)


def test_prep_checksum_matches_verify_prep_on_jax_engine():
    """timed_preps' checksums (seeds 2, 3, 4 after a warm prep) equal
    scripts/verify_prep.py's checksum of the JAX engine's state from the
    same numpy seeds."""
    n = 8192
    raw = bench.synth_raw(n, 160)
    got = bench.timed_preps(
        DevicePianoEngine(n, 640, 32, raw, 8, device="cpu"), raw)
    ref = JaxEngine(n, 640, 32, raw, 8)
    want = []
    for i in range(3):
        ref.preprocessing(rng=np.random.default_rng(2 + i))
        st = ref.state
        cs = (jnp.sum(st["primary_parity"], dtype=jnp.uint32)
              ^ jnp.sum(st["backup_parity"], dtype=jnp.uint32)
              ^ jnp.sum(st["table"], dtype=jnp.uint32))
        want.append(f"{int(np.asarray(cs)):#010x}")
    assert got["prep_checksums"] == want
    assert len(set(want)) == 3 and got["rows_exact_after_prep"] == "16/16"


def test_prep_check_raises_when_prep_does_nothing(monkeypatch):
    """A prep that leaves the state as it was fails the check."""
    n = 8192
    raw = bench.synth_raw(n, 160)
    e = DevicePianoEngine(n, 640, 32, raw, 8, device="cpu")
    e.preprocessing(rng=np.random.default_rng(1))
    monkeypatch.setattr(e, "preprocessing", lambda rng=None: None)
    with pytest.raises(bench.PrepCheckError, match="not distinct"):
        bench.timed_preps(e, raw)


def _port_search(seed=31, n=1024, d=8, m=8):
    rng = np.random.default_rng(seed)
    vectors = rng.integers(0, 8, size=(n, d)).astype(np.float32)
    graph = rng.integers(0, n, size=(n, m))
    raw = pack_vertex_db(vectors, graph)
    sids = np.random.default_rng(seed + 1).choice(n, 32, replace=False)
    e = DevicePianoEngine(n, 4 * (d + m), m, raw, 8, device="cpu")
    e.preprocessing(rng=np.random.default_rng(99))
    return FusedPrivateSearch(e, sids, vectors[sids], graph[sids], dim=d,
                              m=m, n=n)


@pytest.mark.parametrize("Qn,parallel,max_step", [(1, 3, 6), (2, 2, 5)])
def test_device_steps_match_search(monkeypatch, Qn, parallel, max_step):
    """device_steps from the same generator seed leaves the beam, answers,
    fetch counters and engine state that fs.search leaves."""
    seen = {}
    real = fused_search.finish_topk

    def spy(ids, dist, **kw):
        seen["beam"] = (ids.clone(), dist.clone())
        return real(ids, dist, **kw)

    monkeypatch.setattr(fused_search, "finish_topk", spy)
    ref, got = _port_search(), _port_search()
    q = np.random.default_rng(5).integers(0, 8, (Qn, 8)).astype(np.float32)
    ref.generator.manual_seed(17)
    ids_r, steps_r = ref.search(q, k=5, max_step=max_step, parallel=parallel,
                                return_steps=True)
    assert ref.refreshes == 0
    got.generator.manual_seed(17)
    beam, stats = bench.device_steps(got, torch.as_tensor(q), max_step,
                                     parallel)
    assert torch.equal(beam[0], seen["beam"][0])
    assert torch.equal(beam[1], seen["beam"][1])
    ids_g, steps_g = finish_topk(beam[0], beam[1], topk=5, parallel=parallel,
                                 m=8)
    assert np.array_equal(ids_g.numpy(), ids_r)
    assert np.array_equal(steps_g.numpy(), steps_r)
    assert (ids_r >= 0).any()
    assert np.array_equal(stats.numpy(), ref.fetch_stats)
    assert got.engine.consumed() == ref.engine.queries_made_in_partition
    want = state_to_numpy(ref.engine.state)
    have = state_to_numpy(got.engine.state)
    for key, v in want.items():
        assert np.array_equal(have[key], v), key


def test_linear_scan_product_matches_jax_inner_product(monkeypatch):
    """linear_inputs are bench.py's draws (points, then queries, from
    default_rng(0)), and their product through the port equals JAX's."""
    qs, v = bench.linear_inputs(4096)
    rng = np.random.default_rng(0)
    assert np.array_equal(v, rng.integers(0, 2**16, (4096, 128), np.uint32))
    assert np.array_equal(qs, rng.integers(0, 2**16, (100, 128), np.uint32))
    out, _ = bench.timed_product(qs, v, torch.device("cpu"))
    want = np.asarray(inner_product_xla(jnp.asarray(qs), jnp.asarray(v)))
    assert out.dtype == torch.int32 and np.array_equal(out.numpy(), want)
    monkeypatch.setattr(bench, "LINEAR_N", 4096)
    line = bench.linear_scan(device="cpu")
    metric, keys = BENCH_PY["linear_scan"]
    assert line["metric"] == metric and keys <= set(line["extra"])
    assert line["extra"]["dots"] == 409_600
    assert line["extra"]["sampled_products_exact"] == "32/32"


def test_big_perf_at_small_n_serves_rows_exactly(monkeypatch):
    """big_perf's path at n = 8,192: every row it serves is its raw row
    (timed_batches raises on one that is neither exact nor zero), the
    prep checks hold, and batch-32 success is at least the FCFS model of
    two rounds' quota (a batch and its retry round)."""
    monkeypatch.setattr(bench, "BIG_N", 8192)
    line = bench.big_perf(device="cpu")
    metric, keys = BENCH_PY["big_perf"]
    assert line["metric"] == metric and keys <= set(line["extra"])
    x = line["extra"]
    assert x["n"] == 8192 and x["entry_bytes"] == 896
    assert len(set(x["prep_checksums"])) == 3
    assert x["rows_exact_after_prep"] == "16/16"
    assert x["batch_success_rate"] >= expected_success_rate(32, 16, 4, 8)
    assert x["estimated_ann_latency_ms"] == pytest.approx(
        (x["batch_ms"] * 2 + 50) * 15, abs=0.2)


def test_bench_imports_no_jax():
    code = ("import sys, pacmann_tpu_torch.bench, bench_torch; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'pacmann_tpu', 'bench')))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120,
                          check=True)
    assert proc.stdout.strip() == "[]"
