// K2: gather-XOR parity scan over the chunk-major PIR database, for sm_90a.
//
// Replaces the Pallas kernel `_hintgen_mm_kernel_s8` and its bf16 sibling
// `_hintgen_mm_kernel` (pacmann_tpu/ops/xor_scan.py, reached through
// xor_hintgen_mm): out[p, b] = XOR_s db4[s, p, off[p, b, s]], where an entry
// is k rows of 128 u32 and an offset outside [0, C) is a skip (contributes
// zero). One kernel serves offline hint generation (B = T hints per
// partition) and the online server scan (B = Q sub-queries per partition).
//
// The TPU kernel selects rows with one-hot int8 matrix products because
// Mosaic cannot gather rows; Hopper gathers directly. Each row b of the
// output gets one warp. Lane l owns 16 bytes (one uint4) of every 128-word
// row of the entry, so a warp reads each 512-byte row as one coalesced
// request, walks the S chunks, XOR-accumulates k uint4 in registers and
// writes its parity once. Lanes never exchange data.
//
// Bound on the H100: device memory. Hint generation at SIFT1M shape reads
// 16 * 12512 * 124 entries of 1 KB, about 25 GB, with no reuse planned
// (rows are PRF-random); the 50 MB L2 catches only accidental reuse. The
// design makes every byte moved a full 512-byte coalesced row and keeps
// the accumulator out of memory. A warp stages kUnroll chunks' offsets and
// then their rows before XOR-ing, so it has kUnroll * k loads in flight
// instead of one: the online shapes (96 or 1536 rows) have too few warps
// to hide latency otherwise. Ordering rows for L2 reuse is later work.

#include <cstdint>
#include <cuda_runtime.h>

constexpr int kThreads = 256;   // 8 warps = 8 output rows per block
constexpr int kUnroll = 8;      // chunks staged per step of the S loop

template <int K>
__global__ void __launch_bounds__(kThreads) xor_gather_kernel(
    const uint4* __restrict__ db,        // (S, P, C*K, 32) uint4
    const int32_t* __restrict__ offsets, // (P, B, S)
    uint4* __restrict__ out,             // (P, B, K, 32) uint4
    int S, int P, int C, int B) {
  const long long row = (static_cast<long long>(blockIdx.x) * blockDim.x +
                         threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  if (row >= static_cast<long long>(P) * B) return;
  const int p = static_cast<int>(row / B);
  const int32_t* off_row = offsets + row * S;
  const size_t chunk_stride = static_cast<size_t>(C) * K * 32;  // uint4
  const uint4* db_p = db + static_cast<size_t>(p) * chunk_stride + lane;
  const size_t s_stride = static_cast<size_t>(P) * chunk_stride;
  uint4 acc[K];
#pragma unroll
  for (int r = 0; r < K; ++r) acc[r] = make_uint4(0u, 0u, 0u, 0u);
  for (int s0 = 0; s0 < S; s0 += kUnroll) {
    int32_t off[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      off[u] = (s0 + u < S) ? __ldg(off_row + s0 + u) : -1;
    }
    uint4 v[kUnroll][K];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool live = static_cast<uint32_t>(off[u]) <
                        static_cast<uint32_t>(C);
      const uint4* src = live ? db_p + static_cast<size_t>(s0 + u) * s_stride +
                                    static_cast<size_t>(off[u]) * K * 32
                              : db_p;
#pragma unroll
      for (int r = 0; r < K; ++r) {
        v[u][r] = live ? __ldg(src + r * 32) : make_uint4(0u, 0u, 0u, 0u);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int r = 0; r < K; ++r) {
        acc[r].x ^= v[u][r].x;
        acc[r].y ^= v[u][r].y;
        acc[r].z ^= v[u][r].z;
        acc[r].w ^= v[u][r].w;
      }
    }
  }
  uint4* dst = out + row * K * 32 + lane;
#pragma unroll
  for (int r = 0; r < K; ++r) dst[r * 32] = acc[r];
}

template <int K>
static void launch(const void* db, const void* offsets, void* out, int S,
                   int P, int C, int B, unsigned int blocks,
                   cudaStream_t stream) {
  xor_gather_kernel<K><<<blocks, kThreads, 0, stream>>>(
      static_cast<const uint4*>(db), static_cast<const int32_t*>(offsets),
      static_cast<uint4*>(out), S, P, C, B);
}

// db: (S, P, C*k, 128) int32; offsets: (P, B, S) int32; out: (P, B, k*128)
// int32 — all device buffers, contiguous, 16-byte aligned. Returns the
// cudaError_t of the launch (0 on success); k outside 1..4 is refused with
// cudaErrorInvalidValue.
extern "C" int xor_gather(const void* db, const void* offsets, void* out,
                          int S, int P, int C, int k, int B, void* stream) {
  const long long rows = static_cast<long long>(P) * B;
  if (rows <= 0) return 0;
  const unsigned int blocks =
      static_cast<unsigned int>((rows * 32 + kThreads - 1) / kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1: launch<1>(db, offsets, out, S, P, C, B, blocks, st); break;
    case 2: launch<2>(db, offsets, out, S, P, C, B, blocks, st); break;
    case 3: launch<3>(db, offsets, out, S, P, C, B, blocks, st); break;
    case 4: launch<4>(db, offsets, out, S, P, C, B, blocks, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
