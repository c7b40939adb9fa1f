"""The fused search's step buffers (private/fused_search.py::StepGraphs) on
the CPU, where every step runs eagerly: the step randoms drawn into a
buffer are the allocating draw's, the beam seeded into given tensors is
_seed_beam's, one search object at two group sizes answers as fresh
objects do, and run_steps without a graph set is the step loop written
out, with the round's whole entries padded as it was."""

import numpy as np
import pytest
import torch

from pacmann_tpu_torch.graph.beam import first_occurrence
from pacmann_tpu_torch.pir.convert import state_to_numpy
from pacmann_tpu_torch.pir.device_engine import DevicePianoEngine
from pacmann_tpu_torch.private import fused_search as fsm
from pacmann_tpu_torch.utils.u32 import as_f32

torch.set_num_threads(1)

N, D, M = 1024, 8, 8


def _search(seed=7, engine=None):
    """A tiny prepared engine on the CPU (or `engine`) and a fused search
    over it."""
    rng = np.random.default_rng(seed)
    vectors = rng.integers(0, 8, size=(N, D)).astype(np.float32)
    graph = rng.integers(0, N, size=(N, M))
    if engine is None:
        raw = np.concatenate([vectors.view(np.uint32),
                              graph.astype(np.uint32)], axis=1)
        engine = DevicePianoEngine(N, 4 * (D + M), M, raw, 8, device="cpu")
        engine.preprocessing(rng=np.random.default_rng(seed + 1))
    sids = rng.choice(N, 32, replace=False)
    return fsm.FusedPrivateSearch(engine, sids, vectors[sids], graph[sids],
                                  dim=D, m=M, n=N)


def _queries(seed, Qn):
    return np.random.default_rng(seed).integers(0, 8, (Qn, D)).astype(
        np.float32)


@pytest.mark.parametrize("Qn,parallel,max_step", [(1, 3, 20), (4, 2, 5)])
def test_draw_into_a_buffer_is_the_allocating_draw(Qn, parallel, max_step):
    """rand_out receives the rand_ids the allocating draw gives from the
    same generator seed, and the rnd drawn after it is the same too."""
    kw = dict(max_step=max_step, Qn=Qn, parallel=parallel, m=M, n=N,
              quota=Qn * parallel * M // 16, P=16, S=16, C=64, device="cpu")
    gen = torch.Generator()
    gen.manual_seed(2**31 + 5)
    want = fsm.draw_step_randoms(gen, **kw)
    gen.manual_seed(2**31 + 5)
    buf = torch.full((max_step, Qn, parallel, M), -7, dtype=torch.int32)
    got = fsm.draw_step_randoms(gen, rand_out=buf, **kw)
    assert got[0] is buf
    assert torch.equal(buf, want[0]) and torch.equal(got[1], want[1])


def test_seeding_given_tensors_is_seed_beam():
    """_seed_beam into tensors holding another search's values fills
    them whole: the beam a fresh _seed_beam gives."""
    fs = _search()
    q = torch.as_tensor(_queries(3, 2))
    kw = dict(parallel=3, cap=3 + 4 * 3 * M, m=M)
    want = fsm._seed_beam(q, fs.start_ids, fs.start_vecs, fs.start_nbrs, **kw)
    out = tuple(torch.zeros_like(t) for t in want)
    out[0].fill_(5)
    out[1].fill_(0.5)
    out[2].fill_(9)
    out[3].fill_(False)
    got = fsm._seed_beam(q, fs.start_ids, fs.start_vecs, fs.start_nbrs,
                         out=out, **kw)
    assert got is out
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_one_object_at_two_group_sizes_answers_as_fresh_objects():
    """One search object runs groups of 1, 3 and 1 again; on an engine
    with the same prep, a fresh object a group size runs the same
    sequence: the same answers, steps, fetch counters and engine state,
    though the first reuses its buffers across searches and sizes."""
    one, first = _search(), _search()
    fresh = {1: first, 3: _search(engine=first.engine)}
    runs = [(1, 3, 6), (3, 2, 5), (1, 3, 6), (3, 2, 5)]
    for i, (Qn, parallel, max_step) in enumerate(runs):
        q = _queries(10 + i, Qn)
        out = []
        for fs in (one, fresh[Qn]):
            fs.generator.manual_seed(40 + i)
            out.append(fs.search(q, k=5, max_step=max_step,
                                 parallel=parallel, return_steps=True))
        (ids_a, st_a), (ids_b, st_b) = out
        assert np.array_equal(ids_a, ids_b) and np.array_equal(st_a, st_b)
        assert (ids_a >= 0).any()
    assert len(one.step_graphs) == 2
    assert np.array_equal(one.fetch_stats,
                          fresh[1].fetch_stats + fresh[3].fetch_stats)
    want = state_to_numpy(fresh[1].engine.state)
    have = state_to_numpy(one.engine.state)
    for key, v in want.items():
        assert np.array_equal(have[key], v), key


def _loop_written_out(fs, beam, stats, queries, rand_all, rnd_all, steps, *,
                      parallel, quota):
    """The step loop as one function: routing, the round, the round's whole
    entries padded with a zero row, decode and the window's update."""
    e = fs.engine
    P, k = e.config.partition_num, e.k
    ids, dist, nbrs, explored = beam
    Qn, pm = queries.shape[0], parallel * M
    for g in range(steps):
        (fid, known, is_first, keep, slot, fo_idx, has_first,
         idx_q) = fsm._route_core(*beam, rand_all[g],
                                  psize=e.config.partition_size, m=M, P=P,
                                  parallel=parallel, quota=quota, n=N)
        entries, oks = e._round(idx_q, rnd_all[g])
        ent = torch.cat([entries.reshape(quota * P, k * 128),
                         torch.zeros((1, k * 128), dtype=torch.int32)])
        ok = torch.cat([oks.reshape(quota * P), torch.zeros(1, dtype=bool)])
        sfo = torch.where(has_first, slot[fo_idx], -1)
        rslot = torch.where(sfo >= 0, sfo, quota * P)
        res = ent[rslot]
        res_ok = ok[rslot] & keep[fo_idx] & has_first
        cdist = ((as_f32(res[:, :D])
                  - queries.repeat_interleave(pm, dim=0)) ** 2).sum(dim=-1)
        fid_q, nb_q = fid.reshape(Qn, pm), res[:, D:D + M].reshape(Qn, pm, M)
        accept = (~known & first_occurrence(fid_q) & (nb_q != 0).any(dim=2)
                  & res_ok.reshape(Qn, pm))
        w = slice(parallel + g * pm, parallel + (g + 1) * pm)
        ids[:, w] = torch.where(accept, fid_q, -1)
        dist[:, w] = torch.where(accept, cdist.reshape(Qn, pm), fsm.INF)
        nbrs[:, w] = torch.where(accept[:, :, None], nb_q, 0)
        explored[:, w] = ~accept
        stats += torch.stack([is_first.sum(), keep.sum(), oks.sum()])


@pytest.mark.parametrize("Qn,parallel,max_step", [(1, 3, 6), (2, 2, 5)])
def test_run_steps_without_graphs_is_the_loop_written_out(Qn, parallel,
                                                          max_step):
    """run_steps on the caller's own tensors (bench.py's device_steps) and
    the loop written out, each on an engine with the same prep, from the
    same seeded draws: the same beam, fetch counters and engine state."""
    out = []
    for run in (fsm.FusedPrivateSearch.run_steps, _loop_written_out):
        fs = _search()
        q = torch.as_tensor(_queries(5, Qn))
        P = fs.engine.config.partition_num
        quota = Qn * parallel * M // P
        beam = fsm._seed_beam(q, fs.start_ids, fs.start_vecs, fs.start_nbrs,
                              parallel=parallel,
                              cap=parallel + max_step * parallel * M, m=M)
        fs.generator.manual_seed(17)
        p = fs.engine.params
        rand_all, rnd_all = fsm.draw_step_randoms(
            fs.generator, max_step=max_step, Qn=Qn, parallel=parallel, m=M,
            n=N, quota=quota, P=P, S=p.set_size, C=p.chunk_size,
            device="cpu")
        stats = torch.zeros(3, dtype=torch.int64)
        if run is _loop_written_out:
            run(fs, beam, stats, q, rand_all, rnd_all, max_step,
                parallel=parallel, quota=quota)
        else:
            run(fs, beam, stats, q, rand_all, rnd_all, 0, max_step,
                parallel=parallel, quota=quota)
        out.append((beam, stats, state_to_numpy(fs.engine.state)))
    (beam_a, stats_a, st_a), (beam_b, stats_b, st_b) = out
    for a, b in zip(beam_a, beam_b):
        assert torch.equal(a, b)
    assert torch.equal(stats_a, stats_b) and stats_a[0] > 0
    assert (beam_a[0][:, parallel:] >= 0).any()
    for key, v in st_b.items():
        assert np.array_equal(st_a[key], v), key
