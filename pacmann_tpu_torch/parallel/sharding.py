"""Device-mesh sharding for the PIR server engine and distance scans: the
port of the JAX package's parallel/sharding.py.

The reference's scaling axes map onto a 1-D mesh of devices, axis
"shard":

  * XOR parity scans (the PIR server's online compute and the offline
    hint generation, pir.go:65-88/303-352) shard the chunk axis: each
    shard streams its own chunks and XORs PRF-selected rows into partial
    parities (kernel K2 on CUDA). XOR over disjoint chunk sets composes,
    so the partials combine with an XOR all-reduce: gather the partials,
    fold them lane-wise with XOR (no collective library has an XOR sum).
  * Brute-force distance scans shard the DB-row axis: a (Q, B_local)
    distance tile per shard (kernel K6 on CUDA) and a local top-k, then a
    global top-k merge of the gathered candidates (the linear-scan
    baseline of graphann_test.go:221-284 at multi-device scale).

One process drives every shard, as the reference's single-controller
shard_map does: a sharded tensor is a list of per-shard tensors, one on
each mesh device, and a replicated tensor one copy per distinct device. A
mesh may name one device several times (["cuda:0"] * 4 is four logical
shards on one card, ["cpu"] * 8 the tests' twin of the reference's eight
virtual CPU devices); the shards then share that device, and the results
are the same as on distinct devices.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from pacmann_tpu_torch.ops import xor_scan
from pacmann_tpu_torch.ops.distance import l2_distance
from pacmann_tpu_torch.utils.u32 import smallest_k_keyed

AXIS = "shard"


def _normal(device) -> torch.device:
    """A device with its index: "cuda" is the current CUDA device."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclass(frozen=True)
class Mesh:
    """An ordered tuple of devices on axis "shard"; repeats allowed."""

    devices: tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def distinct(self) -> tuple[torch.device, ...]:
        """The devices the mesh spans, in first-use order."""
        return tuple(dict.fromkeys(self.devices))

    def describe(self) -> str:
        return f"{self.size} shards on {len(self.distinct)} device(s)"


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """A mesh of n_devices shards. devices: an explicit list (repeats
    allowed), cut to n_devices when both are given; None means the CUDA
    devices round-robin, cuda:(i % count), n_devices of them (all of them
    when n_devices is None); it raises where CUDA is not available."""
    if devices is not None:
        devs = tuple(_normal(d) for d in devices)
        if n_devices is not None:
            if n_devices > len(devs):
                raise ValueError(f"{n_devices} shards asked of "
                                 f"{len(devs)} devices")
            devs = devs[:n_devices]
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh without devices needs CUDA; pass "
                               "devices=['cpu'] * n for a CPU mesh")
        count = torch.cuda.device_count()
        n = count if n_devices is None else n_devices
        devs = tuple(torch.device("cuda", i % count) for i in range(n))
    if not devs:
        raise ValueError("a mesh needs at least one device")
    return Mesh(devs)


def shard_db(mesh: Mesh, x: torch.Tensor, axis: int = 0) -> list:
    """Split x on `axis` into mesh.size equal contiguous shards, shard d on
    mesh.devices[d] (the reference's P(AXIS) placement). The axis must
    divide by the mesh."""
    if x.shape[axis] % mesh.size:
        raise ValueError(f"axis {axis} of {tuple(x.shape)} is not "
                         f"divisible by {mesh.size} shards")
    return [part.to(dev).contiguous()
            for part, dev in zip(x.chunk(mesh.size, dim=axis), mesh.devices)]


def shard_rows(mesh: Mesh, x: torch.Tensor) -> list:
    """Split the rows of x into mesh.size contiguous shards, the first
    n % mesh.size one row longer (torch.tensor_split's rule; no padding
    rows), shard d on mesh.devices[d]."""
    return [part.to(dev).contiguous()
            for part, dev in zip(torch.tensor_split(x, mesh.size),
                                 mesh.devices)]


def replicate(mesh: Mesh, x: torch.Tensor) -> list:
    """One copy of x per distinct mesh device, listed per shard: shards on
    one device share one tensor."""
    copies = {dev: x.to(dev) for dev in mesh.distinct}
    return [copies[dev] for dev in mesh.devices]


def _on(mesh: Mesh, x, d: int) -> torch.Tensor:
    """Shard d's copy of x: a per-shard list's entry, or x moved there."""
    return x[d] if isinstance(x, (list, tuple)) else x.to(mesh.devices[d])


def xor_allreduce(parts: list) -> torch.Tensor:
    """The XOR all-reduce: gather the partials onto the first one's device
    and fold them lane-wise with XOR (the reference's all_gather + XOR
    reduce, sharding.py:44-47)."""
    out = parts[0].clone()
    for part in parts[1:]:
        out ^= part.to(out.device)
    return out


def sharded_xor_scan(mesh: Mesh, db, offsets, skip, k: int) -> torch.Tensor:
    """Chunk-sharded XOR scan with the XOR all-reduce.

    db: shard_db of an (S, C*k, 128) int32 DB (S_loc chunks a shard);
    offsets (B, S) int32 and skip (B, S) bool, tensors or replicate()
    lists, each shard reading its own columns. One K2 launch a shard on
    CUDA (xor_scan.xor_hintgen). Returns (B, k, 128) int32 on the first
    shard's device."""
    parts, s0 = [], 0
    for d, db_loc in enumerate(db):
        s1 = s0 + db_loc.shape[0]
        off = _on(mesh, offsets, d)[:, s0:s1]
        sk = _on(mesh, skip, d)[:, s0:s1]
        out = xor_scan.xor_hintgen(db_loc[:, None], off[None], sk[None], k)
        parts.append(out[0])
        s0 = s1
    B = parts[0].shape[0]
    return xor_allreduce(parts).reshape(B, k, 128)


def sharded_l2_topk(mesh: Mesh, queries, vectors, k: int):
    """Row-sharded exact k-NN: a distance tile and a top-k per shard, then
    a global merge. queries (Q, D) f32, a tensor or a replicate() list;
    vectors: per-shard (n_d, D) f32 tensors (shard_rows or shard_db), shard
    d holding global rows [sum of the earlier n, + n_d). One l2_distance
    (kernel K6 on CUDA) a shard.

    Returns (ids (Q, k) int64 global, dists (Q, k) f32) on the first
    shard's device, ascending, equal distances by the lower global id:
    lax.top_k's order over the whole row, which the reference's merge
    keeps. Every row of `vectors` is a real row, so no padding row can
    win (the reference pads with +inf rows, which its distance turns into
    NaN and its top-k ranks first)."""
    home = mesh.devices[0]
    vals, ids, base = [], [], 0
    for d, v_loc in enumerate(vectors):
        dist = l2_distance(_on(mesh, queries, d), v_loc)     # (Q, n_d)
        gid = torch.arange(base, base + v_loc.shape[0], device=dist.device)
        dv, di = smallest_k_keyed(dist, gid, min(k, v_loc.shape[0]))
        vals.append(dv.to(home))
        ids.append(di.to(home))
        base += v_loc.shape[0]
    dists, gids = smallest_k_keyed(torch.cat(vals, dim=1),
                                   torch.cat(ids, dim=1), min(k, base))
    return gids, dists
