// K6: tiled squared L2 distance, (Q, D) x (B, D) -> (Q, B) f32, for sm_90a.
//
// Replaces the Pallas kernel `_l2_kernel` (pacmann_tpu/ops/distance.py,
// reached through l2_distance_pallas): out[i, j] = max((|q_i|^2 + |p_j|^2)
// - 2 q_i.p_j, 0) in fp32, the formula and order of the reference's
// l2_distance_xla. Any Q, B and D: ragged edges are masked here, where the
// TPU kernel padded to (8, 128) tiles.
//
// Bound on the H100: operations. At the exact-search shape (1,000 x 1M x
// 128) the product is 2.56e11 flops, 3.8 ms at the fp32 FMA peak (132 SMs
// x 128 lanes x 2 x 1.98 GHz), against 1.2 ms to write the 4 GB output.
// The product stays in plain fp32 FFMA (no TF32, no tensor cores), as the
// reference's Precision.HIGHEST asks. The design is a register-tiled SGEMM
// whose every shared-memory access is free of bank conflicts:
//   - a CTA of 8 warps owns a 128 x 128 output tile; warp (wm, wn) of the
//     4 x 2 warp grid owns rows wm*32 + ty + 4i and columns wn*64 + tx + 8j
//     (i, j < 8; lane = 8 ty + tx), an 8 x 8 micro-tile of sums in
//     registers;
//   - D streams through shared memory in slabs of 32, each operand's rows
//     stored as they lie in device memory (k contiguous) with a pad of 4
//     floats, so a thread reads 4 k of a row as one float4; with the
//     36-float row stride the 8 lanes reading a B row (tx) or the 4 reading
//     an A row (ty) fall in distinct 16-byte bank groups, and lanes of
//     equal tx (ty) read the same address (a broadcast);
//   - slabs arrive by 16-byte cp.async (4-byte copies where D % 4 != 0 or
//     a row is not 16-byte aligned; zero fill past the edges) in a ring of
//     kStages, so the loads of slab t + 2 overlap the FMAs of slab t;
//   - each norm is summed once per CTA, thread t taking row t of the A or
//     B slab as it lands, in the same order as the products (k ascending);
//   - the epilogue rounds each step as the reference does (no contraction
//     into an FMA) and clamps (a NaN passes through), so on integer-valued
//     data the result is bit-equal to the plain version.
// Two CTAs fit an SM: 2 x 110,592 B of ring, at most 128 registers a thread
// (no spill stores).

#include <cstdint>
#include <cuda_runtime.h>

#include "cp_async.cuh"

constexpr int kBM = 128;              // output rows (queries) per CTA
constexpr int kBN = 128;              // output columns (points) per CTA
constexpr int kBK = 32;               // D per shared slab
constexpr int kRow = kBK + 4;         // floats per staged row
constexpr int kStages = 3;            // slabs in flight
constexpr int kThreads = 256;         // 4 x 2 warps, 8 x 8 outputs a thread
constexpr int kChunks = kBK / 4;      // float4 per staged row
constexpr int kStageFloats = (kBM + kBN) * kRow;
constexpr int kSmemBytes = kStages * kStageFloats * 4;

// rows [row0, row0 + 128) x slab [k0, k0 + 32) of x (n, D) into dst
// (128 rows of kRow floats), zeros past n and D
__device__ __forceinline__ void stage_rows(float* dst, const float* x, int n,
                                           int D, int row0, int k0, bool vec,
                                           int tid) {
#pragma unroll
  for (int it = 0; it < kBM * kChunks / kThreads; ++it) {
    const int e = tid + it * kThreads;
    const int r = e / kChunks, c = e % kChunks;
    const int g = row0 + r, kk = k0 + c * 4;
    float* d = dst + r * kRow + c * 4;
    const float* src = x + static_cast<size_t>(g) * D + kk;
    if (vec) {
      const bool ok = g < n && kk < D;
      cp_async16(d, ok ? src : x, ok ? 16 : 0);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = g < n && kk + j < D;
        cp_async4(d + j, ok ? src + j : x, ok ? 4 : 0);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2) l2_distance_kernel(
    const float* __restrict__ q,      // (Q, D)
    const float* __restrict__ p,      // (B, D)
    float* __restrict__ out,          // (Q, B)
    int Q, int B, int D, bool vec_in, bool full_cols) {
  extern __shared__ __align__(16) float ring[];   // kStages x (A, B) slabs
  __shared__ float qn_s[kBM];
  __shared__ float pn_s[kBN];

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int rbase = (warp / 2) * 32 + lane / 8;   // rows rbase + 4i
  const int cbase = (warp % 2) * 64 + lane % 8;   // columns cbase + 8j
  const int row0 = blockIdx.y * kBM;
  const int col0 = blockIdx.x * kBN;
  const int slabs = (D + kBK - 1) / kBK;

  auto issue = [&](int t) {
    float* st = ring + (t % kStages) * kStageFloats;
    stage_rows(st, q, Q, D, row0, t * kBK, vec_in, tid);
    stage_rows(st + kBM * kRow, p, B, D, col0, t * kBK, vec_in, tid);
  };
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < slabs) issue(t);
    cp_async_commit();
  }

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  // |q_{row0+tid}|^2 for tid < 128, else |p_{col0+tid-128}|^2: row tid of
  // the staged (A, B) pair
  float norm = 0.f;

  for (int t = 0; t < slabs; ++t) {
    cp_async_wait<kStages - 2>();   // slab t has landed (this thread)
    __syncthreads();                // ... for every thread; slab t-1 done
    if (t + kStages - 1 < slabs) issue(t + kStages - 1);
    cp_async_commit();
    const float* As = ring + (t % kStages) * kStageFloats;
    const float* Bs = As + kBM * kRow;

    const float* own = As + tid * kRow;   // rows 128.. are B's
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const float4 v = *reinterpret_cast<const float4*>(own + c * 4);
      norm = fmaf(v.x, v.x, norm);
      norm = fmaf(v.y, v.y, norm);
      norm = fmaf(v.z, v.z, norm);
      norm = fmaf(v.w, v.w, norm);
    }

    const float* a_rows = As + rbase * kRow;
    const float* b_rows = Bs + cbase * kRow;
    // one float4 column at a time: unrolled further, ptxas spills at the
    // 128-register cap that two CTAs an SM need
#pragma unroll 1
    for (int c = 0; c < kChunks; ++c) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float4 a[4];
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
          a[ii] = *reinterpret_cast<const float4*>(
              a_rows + (h * 4 + ii) * 4 * kRow + c * 4);
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float4 b = *reinterpret_cast<const float4*>(
              b_rows + j * 8 * kRow + c * 4);
#pragma unroll
          for (int ii = 0; ii < 4; ++ii) {
            float& s = acc[h * 4 + ii][j];
            s = fmaf(a[ii].x, b.x, s);
            s = fmaf(a[ii].y, b.y, s);
            s = fmaf(a[ii].z, b.z, s);
            s = fmaf(a[ii].w, b.w, s);
          }
        }
      }
    }
  }

  if (tid < kBM) qn_s[tid] = norm;
  else pn_s[tid - kBM] = norm;
  __syncthreads();

  // epilogue: (qn + pn) - 2*cross, each op rounded on its own, then the
  // clamp (a NaN passes through, as with jnp.maximum); a warp's store for
  // one (i, j) covers 32 contiguous bytes of each of 4 rows
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = rbase + 4 * i;
    const int gq = row0 + r;
    if (gq >= Q) continue;
    const float qn = qn_s[r];
    float* out_row = out + static_cast<size_t>(gq) * B + col0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = cbase + 8 * j;
      const float d = __fsub_rn(__fadd_rn(qn, pn_s[c]),
                                __fmul_rn(2.f, acc[i][j]));
      if (full_cols || col0 + c < B) out_row[c] = d < 0.f ? 0.f : d;
    }
  }
}

// q: (Q, D), p: (B, D), out: (Q, B) — f32 device buffers, contiguous, out
// 4-byte aligned. Returns the cudaError_t of the launch (0 on success);
// more than 65,535 row tiles (Q > 8,388,480) is refused with
// cudaErrorInvalidValue.
extern "C" int l2_distance(const void* q, const void* p, void* out, int Q,
                           int B, int D, void* stream) {
  if (Q <= 0 || B <= 0) return 0;
  const int row_tiles = (Q + kBM - 1) / kBM;
  if (row_tiles > 65535 || D < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  static bool opted = false;
  if (!opted) {
    const cudaError_t rc = cudaFuncSetAttribute(
        l2_distance_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemBytes);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    opted = true;
  }
  const bool vec_in = D % 4 == 0 &&
                      reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(p) % 16 == 0;
  const dim3 grid((B + kBN - 1) / kBN, row_tiles);
  l2_distance_kernel<<<grid, kThreads, kSmemBytes,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(p),
      static_cast<float*>(out), Q, B, D, vec_in, B % kBN == 0);
  return static_cast<int>(cudaGetLastError());
}
