"""PIR-backed vertex oracle — the private GetGraphInfo implementation, the
port of the JAX package's private/oracle.py.

Re-architecture of PIRGraphInfo (the reference's private-search.go:333-528):
the beam-search frontend fetches `vector ‖ neighbor-list` records through
batch PIR so the server never learns which vertices a query touches.

Entry packing matches the reference bit for bit (private-search.go:352-399):
little-endian f32[dim] ‖ u32[m], so DBEntryByteNum = 4*dim + 4*m. The PIR
layer views entries as u32 words. The engines keep their DB on the
oracle's torch device: None means the card (raising where there is none),
"cpu" runs the kernels' plain versions.
"""

from __future__ import annotations

import numpy as np
import torch

from pacmann_tpu_torch.graph.beam_host import VertexOracle
from pacmann_tpu_torch.pir.batch import SimpleBatchPianoPIR
from pacmann_tpu_torch.utils import cuda_lib

FAILURE_PROB_LOG2 = 8  # private-search.go:402


def pack_vertex_db(vectors: np.ndarray, graph: np.ndarray) -> np.ndarray:
    """(n, dim) f32 + (n, m) int -> (n, dim+m) u32 rawDB (LE f32 ‖ u32)."""
    vectors = np.ascontiguousarray(vectors, dtype="<f4")
    graph = np.ascontiguousarray(graph, dtype="<u4")
    return np.concatenate([vectors.view("<u4"), graph], axis=1).astype(np.uint32)


def pack_vertex_db_device(vectors: torch.Tensor,
                          graph: torch.Tensor) -> torch.Tensor:
    """Device twin of pack_vertex_db: (n, dim) f32 ‖ (n, m) int tensors ->
    the raw (n, dim+m) entries as an int32 tensor holding the u32 bits
    (utils/u32.py), on the vectors' device: the f32 bits viewed as int32,
    the graph's ids cut to 32 bits. Device-resident vectors and graph never
    cross to the host."""
    v = vectors.to(torch.float32).contiguous().view(torch.int32)
    # the low 32 bits of each id, as the cast to u32 keeps them
    g = graph.to(device=vectors.device, dtype=torch.int64) & 0xFFFFFFFF
    g = torch.where(g >= 2**31, g - 2**32, g).to(torch.int32)
    return torch.cat([v, g], dim=1)


def unpack_entries(entries: np.ndarray, dim: int, m: int):
    """(B, dim+m) u32 -> ((B, dim) f32 vectors, (B, m) i64 neighbors).

    Entry2VectorAndNeighbors (private-search.go:415-436), vectorized.
    """
    entries = np.ascontiguousarray(entries, dtype="<u4")
    vecs = entries[:, :dim].view("<f4")
    nbrs = entries[:, dim : dim + m].astype(np.int64)
    return vecs, nbrs


class PIRGraphOracle(VertexOracle):
    """Private vertex oracle over a batch PIR engine
    (private-search.go:333). device: the engines' torch device; None means
    the card, and raises where there is none."""

    def __init__(self, vectors: np.ndarray, graph: np.ndarray,
                 skip_prep: bool = False, non_private: bool = False,
                 device=None, engine: str = "fused",
                 rng: np.random.Generator | None = None,
                 failure_prob_log2: int = FAILURE_PROB_LOG2,
                 start_mode: str = "random"):
        self.vectors = np.asarray(vectors, np.float32)
        self.graph = np.asarray(graph, np.int64)
        self.n, self.dim = self.vectors.shape
        self.m = self.graph.shape[1]
        self.skip_prep = skip_prep
        self.non_private = non_private
        self.device = cuda_lib.default_device(None, device)
        self.engine = engine
        self.failure_prob_log2 = failure_prob_log2
        self.start_mode = start_mode
        self.rng = rng or np.random.default_rng()
        # SimpleBatchPianoPIR | FusedBatchPianoPIR | DevicePianoEngine
        self.pir = None
        # success accounting (private-search.go:348-350, 486-499)
        self.total_query_num = 0
        self.succ_query_num = 0

    # -- GetGraphInfo interface ---------------------------------------------

    def preprocess(self):
        entry_bytes = 4 * self.dim + 4 * self.m  # private-search.go:360
        raw = pack_vertex_db(self.vectors, self.graph)
        if self.engine == "device":
            from pacmann_tpu_torch.pir.device_engine import DevicePianoEngine

            self.pir = DevicePianoEngine(
                self.n, entry_bytes, self.m, raw, self.failure_prob_log2,
                device=self.device)
        elif self.engine == "fused":
            from pacmann_tpu_torch.pir.engine import FusedBatchPianoPIR

            self.pir = FusedBatchPianoPIR(
                self.n, entry_bytes, self.m, raw,
                self.failure_prob_log2, device=self.device,
            )
        else:
            self.pir = SimpleBatchPianoPIR(
                self.n, entry_bytes, self.m, raw,
                self.failure_prob_log2, device=self.device,
            )
        if self.skip_prep:
            self.pir.dummy_preprocessing(rng=self.rng)
        else:
            self.pir.preprocessing(rng=self.rng)

    def get_metadata(self):
        return self.n, self.dim, self.m

    def get_vertex_info(self, ids):
        ids = np.asarray(ids, np.int64)
        self.total_query_num += len(ids)

        if self.non_private:  # bypass (private-search.go:442-452)
            return self.vectors[ids], self.graph[ids]

        entries = self.pir.query(ids)
        vecs, nbrs = unpack_entries(entries, self.dim, self.m)

        # per-fetch success accounting vs the plaintext graph
        # (private-search.go:486-499)
        ok = np.all(nbrs == self.graph[ids], axis=1)
        self.succ_query_num += int(np.sum(ok))
        return vecs, nbrs

    def get_start_vertices(self):
        """sqrt(n) seeds. start_mode='random': random distinct seeds, the
        reference's policy (private-search.go:505-528). 'centroid':
        k-means-centroid nearest vertices (graph.build.choose_start_ids, on
        the oracle's device) — better coverage cuts the beam's descent
        depth at large n; the start set is index state either way (same
        count, same query cost)."""
        target = int(np.sqrt(self.n))
        if self.start_mode == "centroid":
            from pacmann_tpu_torch.graph.build import choose_start_ids

            ids = choose_start_ids(self.vectors, target, device=self.device)
        else:
            ids = self.rng.choice(self.n, size=target, replace=False)
        return ids, self.vectors[ids], self.graph[ids]

    # -- stats ---------------------------------------------------------------

    def success_rate(self) -> float:
        if self.total_query_num == 0:
            return 1.0
        return self.succ_query_num / self.total_query_num
