"""The port's scale scripts (pacmann_tpu_torch/scripts/) against the JAX
package's scripts/: the same synthetic data from the same seeds, the demo
and the baselines end to end on the CPU at a small n, the SIFT100M plan's
derived parameters and byte budget, its 8-shard mini run, and the
-torch.sh wrappers' flags."""

import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from pacmann_tpu_torch.pir.device_engine import DevicePianoEngine
from pacmann_tpu_torch.scripts import baselines_scale, e2e_scale, plan_100m
from scripts import e2e_scale as jax_e2e

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("n", [1000, 70_000])
def test_synth_vectors_match_jax_script(n):
    """Both host generators draw what the JAX script draws (n past one
    block of 65,536 rows), and leave the generator where it does."""
    for latent in (16, 0):
        a, b = np.random.default_rng(5), np.random.default_rng(5)
        assert np.array_equal(
            e2e_scale.synth_vectors(n, 128, True, a, latent=latent),
            jax_e2e.synth_vectors(n, 128, True, b, latent=latent))
        assert a.bit_generator.state == b.bit_generator.state
    a, b = np.random.default_rng(6), np.random.default_rng(6)
    assert np.array_equal(e2e_scale.synth_vectors(n, 128, False, a),
                          jax_e2e.synth_vectors(n, 128, False, b))
    a, b = np.random.default_rng(7), np.random.default_rng(7)
    assert np.array_equal(e2e_scale.synth_continuum(n, 128, a, latent=12),
                          jax_e2e.synth_continuum(n, 128, b, latent=12))
    assert a.bit_generator.state == b.bit_generator.state


def test_synth_continuum_device_is_seeded_and_on_its_manifold():
    a = e2e_scale.synth_continuum_device(2048, 128, seed=0, latent=12,
                                         device="cpu")
    b = e2e_scale.synth_continuum_device(2048, 128, seed=0, latent=12,
                                         device="cpu")
    assert a.dtype == torch.float32 and a.shape == (2048, 128)
    assert torch.equal(a, b)
    assert not torch.equal(a, e2e_scale.synth_continuum_device(
        2048, 128, seed=1, latent=12, device="cpu"))
    # rank 12 plus 0.02 noise: the 13th singular value is the noise's
    sv = torch.linalg.svdvals(a.double())
    assert sv[11] > 20 * sv[12]


def test_e2e_scale_small_run_has_the_jax_report(tmp_path):
    """The canonical recipe's flags at n = 8,192 (2 rounds, 16 queries):
    the report holds every key of the JAX report of the 1M run, and
    private recall is within 0.05 of plaintext recall."""
    rep = e2e_scale.main([
        "--n", "8192", "--rounds", "2", "--queries", "16", "--continuum",
        "--device-synth", "--latent", "12", "--keep", "16",
        "--corridor", "16:2:3", "--device", "cpu", "--rebuild",
        "--out", str(tmp_path)])
    path = tmp_path / "e2e_8192_continuum_l12dev_k16c16x2x3_report.json"
    assert json.loads(path.read_text()) == rep
    want = json.loads((REPO / "reports" / "e2e_1000000_continuum_l12dev_"
                       "k16c16x2x3_report.json").read_text())
    assert set(want) <= set(rep), set(want) - set(rep)
    assert rep["device"] == "cpu" and rep["gpu"] is None
    assert rep["peak_gib"] is None          # no device memory on the CPU
    assert rep["private_recall"] >= rep["plaintext_recall"] - 0.05
    assert rep["plaintext_recall"] >= 0.9


def test_baselines_scale_small_run(tmp_path):
    res = baselines_scale.main([
        "--n", "8192", "--latent", "12", "--continuum", "--queries", "16",
        "--device", "cpu", "--out", str(tmp_path)])
    assert res["exact_recall"] == 1.0
    assert 0.0 < res["cluster_recall"] < 1.0
    exact = (tmp_path / "exact-8192_continuum_l12-report.txt").read_text()
    cluster = (tmp_path / "cluster-8192_continuum_l12-report.txt"
               ).read_text()
    assert "Recall@10: 1.0000" in exact and "CPU (" in exact
    assert "TPU" not in exact + cluster
    assert f"Recall@10: {res['cluster_recall']:.4f}" in cluster
    assert "k-means sqrt(n)=90 clusters" in cluster


def test_plan_100m_derived_params_match_the_jax_plan():
    c, p = plan_100m.derive(plan_100m.N)
    want = json.loads((REPO / "reports" / "sift100m_plan.json").read_text())
    got = {"partition_size": c.partition_size, "chunk_size": p.chunk_size,
           "set_size": p.set_size, "primary_hint_num": p.primary_hint_num,
           "max_query_num": p.max_query_num,
           "max_query_per_chunk": p.max_query_per_chunk,
           "total_tags": p.total_tags, "entry_rows": 2}
    assert got == want["derived"]
    assert c.partition_num == want["config"]["partitions"]


def test_plan_100m_bytes_equal_an_engines_state():
    """The plan's per-partition bytes, at the mini run's shape, are the
    bytes a port engine holds: its DB and every state tensor."""
    c, p = plan_100m.derive(plan_100m.MINI_N)
    raw = np.zeros((plan_100m.MINI_N, plan_100m.ENTRY // 4), np.uint32)
    eng = DevicePianoEngine(plan_100m.MINI_N, plan_100m.ENTRY,
                            plan_100m.BATCH, raw, plan_100m.FAIL_LOG2,
                            device="cpu")
    eng.dummy_preprocessing()
    held = eng.db.numel() * 4 + sum(v.numel() * v.element_size()
                                    for v in eng.state.values())
    assert all(v.dtype == torch.int32 for v in eng.state.values())
    per = plan_100m.partition_bytes(p, eng.k)
    assert sum(per.values()) * c.partition_num == held
    assert per["db_shard"] * c.partition_num == eng.db.numel() * 4


def test_plan_100m_fits_and_mini_run(tmp_path):
    plan = plan_100m.main(["--device", "cpu", "--out", str(tmp_path)])
    assert json.loads((tmp_path / "sift100m_plan.json").read_text()) == plan
    assert plan["fits"] and plan["card_memory_gib"] == 80.0
    # a port engine at the SIFT100M shard held 14.886 GB on the H100
    assert sum(plan["per_card_bytes"].values()) == pytest.approx(14.886e9,
                                                                 rel=1e-3)
    assert "offline_prep_est_s_v5e8" not in plan
    mini = plan["mini_run"]
    assert mini["total"] == 32 and mini["exact"] >= 30
    assert mini["mesh"] == "8 shards on 1 device(s)"


def _flags(text: str) -> list:
    body = text[text.index("python -m"):]
    return re.findall(r"(?<![\w$])-[a-z]+", body)


@pytest.mark.parametrize("name,module", [
    ("ann", "ann"), ("cluster-search", "cluster_search"),
    ("private-search", "private_search")])
def test_torch_run_scripts_mirror_the_jax_ones(name, module):
    jax_sh = (REPO / "scripts" / f"run-{name}.sh").read_text()
    torch_sh = (REPO / "scripts" / f"run-{name}-torch.sh").read_text()
    assert f"python -m pacmann_tpu.cli.{module} " in jax_sh
    assert f"python -m pacmann_tpu_torch.cli.{module} " in torch_sh
    assert "pacmann_tpu.cli" not in torch_sh
    assert _flags(torch_sh) == _flags(jax_sh)
    env = sorted(set(re.findall(r"\$\{(\w+)", jax_sh)))
    assert sorted(set(re.findall(r"\$\{(\w+)", torch_sh))) == env
    assert (REPO / "scripts" / f"run-{name}-torch.sh").stat().st_mode & 0o111
