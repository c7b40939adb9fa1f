"""Device-mesh sharding: partition-parallel PIR, XOR all-reduce, top-k
merge."""

from pacmann_tpu_torch.parallel.sharding import (  # noqa: F401
    Mesh,
    make_mesh,
    replicate,
    shard_db,
    shard_rows,
    sharded_l2_topk,
    sharded_xor_scan,
    xor_allreduce,
)
