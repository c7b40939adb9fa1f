"""pacmann_tpu_torch — the PyTorch + CUDA port of pacmann_tpu for NVIDIA
Hopper (H100).

The JAX package (pacmann_tpu) is the reference; this package imports torch
and numpy, never jax. Same layer map as the reference:

  ops/       PRF offset tables (kernel K1, csrc/aes_mmo.cu), the
             gather-XOR parity scan (kernel K2, csrc/xor_gather.cu), the
             client-protocol selects (K3/K4, csrc/protocol.cu) and the
             tiled L2 distance (kernel K6, csrc/l2_distance.cu), each
             beside its plain torch version; the numpy AES oracle.
  pir/       parameter derivation, DB layout, the device-resident batch
             PIR engine, its partition- and chunk-sharded forms, and
             state conversion from the JAX engine.
  parallel/  the device mesh: sharded XOR scans with an XOR all-reduce,
             the row-sharded L2 top-k, the multi-device dry run.
  private/   the PIR-backed vertex oracle, fused private search (beam
             traversal + PIR per step) and the end-to-end driver.
  graph/     plaintext beam search (batched and host), exact k-NN,
             recall and graph quality, k-means start vertices.
  io/        bvecs/fvecs/ivecs/npy/txt loaders, the report writer.
  cli/       private search, exact search (one device or a mesh), the
             plaintext ANN command and the cluster baseline.
  utils/     u32-as-int32 helpers, stable top-k, the nvcc/ctypes loader.
  csrc/      CUDA C++ sources for sm_90a, built on first use.
"""

__version__ = "0.1.0"
