"""The port's private-search driver (private/driver.py, cli/private_search.py)
against the JAX package's on the CPU: the same inputs and seed give the same
answers, reach steps, success rate and report (every field but the times)
on every engine, at concurrent 1 and 8, in benchmarking and non-private
mode, across proactive hint refreshes; "device-fused" with the JAX search's
own step draws fed in. Then the inputs, outputs and errors: synthetic data
and the random graph, the bvecs read, the graph cache name, the output and
report files, the graph build with its cache and aux record, the CLI and
the default device.

The host engines re-key a refresh from secrets.randbits when no generator
is passed (the reference's behaviour); the `pinned_randbits` fixture makes
those keys the same sequence for each package's run."""

import itertools
import os
import secrets
import struct
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from pacmann_tpu.cli import private_search as jcli
from pacmann_tpu.graph.build import build_graph
from pacmann_tpu.graph.recall import brute_force_knn
from pacmann_tpu.io.loaders import load_int_matrix
from pacmann_tpu.pir.params import derive_batch_params, derive_piano_params
from pacmann_tpu.private import driver as jdriver
from pacmann_tpu.private.fused_search import _draw_step_randoms
from pacmann_tpu_torch.cli import private_search as cli
from pacmann_tpu_torch.private import driver

torch.set_num_threads(1)

N, D, M, Q = 1024, 16, 8, 8


@pytest.fixture(scope="module")
def data():
    """Float vectors and queries (as tests/test_private_search.py), a graph
    from the JAX package's build_graph, and integer-valued vectors and
    queries (exact f32 distances, for the device-fused search)."""
    rng = np.random.default_rng(5)
    vecs = rng.random((N, D), dtype=np.float32)
    graph = np.asarray(build_graph(vecs, M, rounds=3, seed=5), np.int64)
    queries = rng.random((Q, D), dtype=np.float32)
    ivecs = np.floor(vecs * 16).astype(np.float32)
    iqueries = np.floor(queries * 16).astype(np.float32)
    return vecs, graph, queries, ivecs, iqueries


@pytest.fixture
def pinned_randbits(monkeypatch):
    """Returns a function that restarts secrets.randbits at a fixed
    sequence; call it before each package's run."""
    def restart():
        seq = itertools.count(12345)
        monkeypatch.setattr(secrets, "randbits", lambda k: next(seq))
    return restart


def _report_fields(res):
    return {k: v for k, v in vars(res.report).items() if "time" not in k}


def _assert_same(got, want):
    assert np.array_equal(got.answers, want.answers)
    assert np.array_equal(got.reach_steps, want.reach_steps)
    assert got.success_rate == want.success_rate
    assert got.recall == want.recall
    assert _report_fields(got) == _report_fields(want)


def _jax_step_randoms(cfg):
    """step_randoms_fn drawing what the JAX device-fused search draws for
    `seed` (FusedPrivateSearch.search: split(PRNGKey(seed), max_step))."""
    c = derive_batch_params(cfg.n, 4 * (cfg.dim + cfg.m), cfg.m,
                            cfg.failure_prob_log2)
    p = derive_piano_params(c.partition_size, 4 * (cfg.dim + cfg.m),
                            cfg.failure_prob_log2)
    P = c.partition_num

    def draw(seed, Qn):
        keys = jax.random.split(jax.random.PRNGKey(seed), cfg.max_step)
        a, b = _draw_step_randoms(
            keys, Qn=Qn, parallel=cfg.parallel, m=cfg.m, n=cfg.n,
            quota=Qn * cfg.parallel * cfg.m // P, P=P, S=p.set_size,
            C=p.chunk_size)
        return np.asarray(a), np.asarray(b)
    return draw


def _run_both(restart, kw, arrays, step_randoms=False):
    restart()
    want = jdriver.run_private_search(jdriver.PrivateSearchConfig(**kw),
                                      *arrays)
    restart()
    cfg = driver.PrivateSearchConfig(**kw, device="cpu")
    got = driver.run_private_search(
        cfg, *arrays,
        step_randoms_fn=_jax_step_randoms(cfg) if step_randoms else None)
    _assert_same(got, want)
    return got, want


MODES = {"sequential": {}, "concurrent": {"concurrent": 8},
         "benchmarking": {"benchmarking": True},
         "non_private": {"non_private": True}}


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("engine", ["simple", "fused", "device"])
def test_driver_matches_jax(data, pinned_randbits, engine, mode):
    """q = 8 queries of 8 steps at parallel 2 spend the budget of 88
    sub-queries a partition: the proactive refresh runs (maintenance > 0)
    in every private mode but benchmarking."""
    vecs, graph, queries, _, _ = data
    kw = dict(n=N, dim=D, m=M, k=10, q=Q, max_step=8, parallel=2,
              build_graph=False, seed=7, engine=engine, **MODES[mode])
    got, want = _run_both(pinned_randbits, kw,
                          (vecs, graph, queries,
                           brute_force_knn(vecs, queries, 10)))
    if mode in ("sequential", "concurrent"):
        assert got.maintenance_time_s > 0 and want.maintenance_time_s > 0
        assert got.recall > 0.3 and got.success_rate > 0.5
    if mode == "benchmarking":
        assert (got.answers == -1).all()
    if mode == "non_private":
        assert got.maintenance_time_s == 0.0


@pytest.mark.parametrize("concurrent,benchmarking",
                         [(3, False), (3, True), (8, False)])
def test_device_fused_matches_jax(data, concurrent, benchmarking):
    """engine="device-fused" on integer-valued vectors with the JAX
    search's draws: the warm-up, the fresh budget, the padded last group
    and the refreshes inside the searches (dummy ones in benchmarking
    mode) as the JAX driver runs them; group 8 is the canonical run's
    (scripts/run-private-search.sh). q = 8 queries of 8 steps cross at
    least one refresh at every group size."""
    _, graph, _, ivecs, iqueries = data
    kw = dict(n=N, dim=D, m=M, k=10, q=Q, max_step=8, parallel=2,
              build_graph=False, seed=3, engine="device-fused",
              concurrent=concurrent, benchmarking=benchmarking)
    got, want = _run_both(lambda: None, kw, (ivecs, graph, iqueries),
                          step_randoms=True)
    assert got.maintenance_time_s > 0 and want.maintenance_time_s > 0
    if not benchmarking:
        assert (got.answers >= 0).any()


def test_synthetic_inputs_and_random_graph_match_jax(capsys,
                                                      pinned_randbits):
    """No arrays, no files: vectors, the random graph (build_graph=False)
    and queries drawn from the seed's generator in the JAX order, then the
    engine's prep and the start ids from the same generator; the
    refreshes' keys pinned."""
    kw = dict(n=512, dim=8, m=8, k=5, q=3, max_step=4, parallel=2,
              build_graph=False, seed=11, engine="simple")
    want = jdriver._load_or_make_inputs(jdriver.PrivateSearchConfig(**kw),
                                        np.random.default_rng(11))
    got = driver._load_or_make_inputs(driver.PrivateSearchConfig(**kw),
                                      np.random.default_rng(11))
    assert got[3] == {}  # nothing built
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    g = got[1]
    assert not (g == np.arange(512)[:, None]).any()
    assert "RANDOM graph" in capsys.readouterr().out
    pinned_randbits()
    got = driver.run_private_search(
        driver.PrivateSearchConfig(**kw, device="cpu"))
    pinned_randbits()
    _assert_same(got, jdriver.run_private_search(
        jdriver.PrivateSearchConfig(**kw)))


def _write_bvecs(path, mat):
    with open(path, "wb") as f:
        for row in mat:
            f.write(struct.pack("<i", mat.shape[1]))
            f.write(row.tobytes())


def test_bvecs_input_and_graph_cache_name(data, tmp_path, monkeypatch):
    """A .bvecs input is read once in its byte form (keep_bytes=True) and
    widened; with no -graph the graph is looked up under the reference's
    cache name {dir}/{data}_{n}_{dim}_{m}_graph.npy, and both packages load
    the same file (neither builds)."""
    _, graph, _, _, _ = data
    rng = np.random.default_rng(3)
    p = str(tmp_path / "vecs.bvecs")
    _write_bvecs(p, rng.integers(0, 256, size=(N, D), dtype=np.uint8))
    cached = tmp_path / f"vecs_{N}_{D}_{M}_graph.npy"
    np.save(cached, graph.astype(np.int32))
    reads = []
    real = driver.load_bvecs
    monkeypatch.setattr(driver, "load_bvecs", lambda *a, **k: (
        reads.append(k), real(*a, **k))[1])
    kw = dict(n=N, dim=D, m=M, k=10, q=4, max_step=6, parallel=2, seed=9,
              input_file=p, engine="device")
    got = driver.run_private_search(driver.PrivateSearchConfig(
        **kw, device="cpu"))
    assert reads == [{"keep_bytes": True}]
    want = jdriver.run_private_search(jdriver.PrivateSearchConfig(**kw))
    _assert_same(got, want)
    assert got.success_rate > 0.5


def test_build_graph_raises_named_error(tmp_path, monkeypatch):
    """No graph file and build_graph=True: the driver builds the graph
    (the port's build_graph, from the config's seed: the graph a direct
    call gives), caches it at the reference's name and writes the aux
    record's three lines next to it, as the JAX driver does; a .bvecs
    input is built from its u8 form; the next run loads the cached graph
    and builds nothing. (It raised before the build was ported.)"""
    from pacmann_tpu_torch.graph import build as tbuild

    rng = np.random.default_rng(4)
    raw = rng.integers(0, 256, size=(300, D), dtype=np.uint8)
    p = str(tmp_path / "base.bvecs")
    _write_bvecs(p, raw)
    inputs = []
    real = tbuild.build_graph

    def spy(vectors, *a, **kw):
        inputs.append(np.asarray(vectors).dtype)
        return real(vectors, *a, **kw)

    monkeypatch.setattr(driver, "build_graph", spy)
    kw = dict(n=300, dim=D, m=M, q=2, max_step=4, parallel=2, seed=6,
              input_file=p, device="cpu")
    res = driver.run_private_search(driver.PrivateSearchConfig(**kw))
    assert inputs == [np.uint8] and res.answers.shape == (2, 10)
    assert set(res.build_stats["phases"]) >= {"bootstrap", "corridors"}
    cached = tmp_path / f"base_300_{D}_{M}_graph.npy"
    graph = load_int_matrix(str(cached), 300, M)
    assert np.array_equal(graph, real(raw, M, seed=6, device="cpu"))
    aux = (tmp_path / f"base_300_{D}_{M}_graph_aux.txt").read_text()
    lines = aux.splitlines()
    assert lines[0] == f"Dataset: base_300_{D}_{M}"
    assert lines[1].startswith("Graph generation time: ")
    assert lines[2] == f"n=300 dim={D} m={M}"
    again = driver.run_private_search(driver.PrivateSearchConfig(**kw))
    assert inputs == [np.uint8] and again.build_stats == {}
    # synthetic vectors with an explicit graph file: built and saved there
    out = tmp_path / "missing.npy"
    driver.run_private_search(driver.PrivateSearchConfig(
        n=64, dim=4, m=4, q=2, device="cpu", input_file="synthetic",
        graph_file=str(out)))
    assert load_int_matrix(str(out), 64, 4).shape == (64, 4)
    assert (tmp_path / "missing_aux.txt").read_text().startswith(
        "Dataset: synthetic_64_4_4\n")


@pytest.mark.parametrize("ext", [".txt", ".npy"])
def test_output_and_report_files_match_jax(data, pinned_randbits, tmp_path,
                                          ext):
    """The answers file in both formats byte for byte, and the appended
    report line for line but for the time lines; the refreshes' keys
    pinned."""
    vecs, graph, queries, _, _ = data
    files = {}
    for name, mod, extra in (("jax", jdriver, {}),
                             ("port", driver, {"device": "cpu"})):
        pinned_randbits()
        out, rep = tmp_path / f"{name}{ext}", tmp_path / f"{name}.report"
        res = mod.run_private_search(
            mod.PrivateSearchConfig(n=N, dim=D, m=M, k=10, q=4, max_step=6,
                                    parallel=2, build_graph=False, seed=3,
                                    output_file=str(out),
                                    report_file=str(rep), **extra),
            vecs, graph, queries[:4])
        files[name] = (out.read_bytes(), rep.read_text(), res)
    assert files["port"][0] == files["jax"][0]
    assert np.array_equal(load_int_matrix(str(tmp_path / f"port{ext}"), 4, 10),
                          files["port"][2].answers)

    def timeless(text):
        return [ln for ln in text.splitlines() if "Time" not in ln]
    assert timeless(files["port"][1]) == timeless(files["jax"][1])
    assert len(files["port"][1].splitlines()) == len(
        files["jax"][1].splitlines())


def test_cli_parser_defaults_match_jax_except_device():
    want = vars(jcli.build_parser().parse_args([]))
    got = vars(cli.build_parser().parse_args([]))
    assert want.pop("device") is False and got.pop("device") is None
    assert got == want
    parse = cli.build_parser().parse_args
    assert parse(["-device"]).device == "cuda"
    assert parse(["-device", "cpu"]).device == "cpu"
    flags = {a.dest: (a.option_strings, a.choices)
             for a in jcli.build_parser()._actions}
    assert {a.dest: (a.option_strings, a.choices)
            for a in cli.build_parser()._actions} == flags


def test_cli_main_report_and_profile(data, pinned_randbits, tmp_path,
                                    capsys):
    """main() with a -graph file, -report and -profile on the CPU: the
    printed report, success rate and maintenance lines, the report file,
    and a Chrome trace in the profile directory."""
    vecs, graph, _, _, _ = data
    gpath = str(tmp_path / "graph.npy")
    np.save(gpath, graph.astype(np.int32))
    rep, prof = tmp_path / "r.txt", tmp_path / "prof"
    argv = ["-n", str(N), "-d", str(D), "-m", str(M), "-q", "3", "-step", "5",
            "-parallel", "2", "-graph", gpath, "-report", str(rep),
            "-profile", str(prof), "-seed", "2"]
    pinned_randbits()
    assert cli.main(argv + ["-device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "Private ANN Benchmarking" in out and "Success rate: " in out
    assert "Maintenance time total (s): " in out
    text = rep.read_text()
    for field in ("Vector Num: 1024", "Preparation Time", "Recall",
                  "Online Communication Per Q"):
        assert field in text
    traces = os.listdir(prof)
    assert len(traces) == 1 and traces[0].endswith(".json")
    assert (prof / traces[0]).stat().st_size > 0
    pinned_randbits()
    assert jcli.main(argv[:-4] + ["-seed", "2"]) == 0
    want = capsys.readouterr().out
    assert ([ln for ln in out.splitlines() if "time" not in ln.lower()]
            == [ln for ln in want.splitlines() if "time" not in ln.lower()])


def test_entry_points_default_to_cuda(data, monkeypatch):
    """device=None (and the CLI without -device) means the card, and raises
    where CUDA is not available."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    vecs, graph, queries, _, _ = data
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        driver.run_private_search(
            driver.PrivateSearchConfig(n=N, dim=D, m=M, q=2,
                                       build_graph=False),
            vecs, graph, queries)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["-n", "64", "-d", "4", "-m", "4", "-q", "2"])


def test_port_imports_no_jax():
    code = ("import sys, pacmann_tpu_torch.private.driver, "
            "pacmann_tpu_torch.private.oracle, "
            "pacmann_tpu_torch.cli.private_search, "
            "pacmann_tpu_torch.graph.build, pacmann_tpu_torch.io.report; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'pacmann_tpu' or "
            "m.startswith('pacmann_tpu.')]; assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True)
