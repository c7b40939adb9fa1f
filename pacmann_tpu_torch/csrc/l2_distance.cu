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
// reference's Precision.HIGHEST asks. The design is the classic register-
// tiled SGEMM: a CTA owns a 128 x 128 output tile, streams D through
// shared memory in slabs of 16 (both operands stored k-major, so a thread
// reads its rows and columns as float4), and each of its 256 threads
// keeps an 8 x 8 micro-tile of sums in registers: 64 FMAs for every 4
// shared-memory reads. The next slab is loaded into registers while the
// current one is multiplied. The norms come from the same shared slabs
// (thread t < 128 sums row t of the query slab, the others a column of
// the point slab), and the clamp is the epilogue, so nothing but the
// output goes back to device memory. The epilogue rounds each step as the
// reference does (no contraction into an FMA), so on integer-valued data
// the result is bit-equal to the plain version.

#include <cstdint>
#include <cuda_runtime.h>

constexpr int kBM = 128;              // output rows (queries) per CTA
constexpr int kBN = 128;              // output columns (points) per CTA
constexpr int kBK = 16;               // D per shared slab
constexpr int kPad = 4;               // float4-aligned rows, 2-way conflicts
constexpr int kThreads = 256;         // 16 x 16 threads, 8 x 8 outputs each
constexpr int kLoads = kBM * kBK / kThreads;   // slab elements per thread

__global__ void __launch_bounds__(kThreads, 2) l2_distance_kernel(
    const float* __restrict__ q,      // (Q, D)
    const float* __restrict__ p,      // (B, D)
    float* __restrict__ out,          // (Q, B)
    int Q, int B, int D, bool vec4) {
  __shared__ __align__(16) float qs[kBK][kBM + kPad];
  __shared__ __align__(16) float ps[kBK][kBN + kPad];
  __shared__ float qn_s[kBM];
  __shared__ float pn_s[kBN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;            // columns tx*4 .. +3 and 64 + tx*4 .. +3
  const int ty = tid / 16;            // rows    ty*4 .. +3 and 64 + ty*4 .. +3
  const int row0 = blockIdx.y * kBM;
  const int col0 = blockIdx.x * kBN;

  // slab loader: element e = tid + i*kThreads of a (128 x 16) slab is row
  // e / 16, k e % 16, so 16 threads read 64 contiguous bytes of one row
  float q_reg[kLoads], p_reg[kLoads];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int e = tid + i * kThreads;
      const int r = e / kBK, k = k0 + e % kBK;
      const int gq = row0 + r, gp = col0 + r;
      q_reg[i] = (gq < Q && k < D) ? q[static_cast<size_t>(gq) * D + k] : 0.f;
      p_reg[i] = (gp < B && k < D) ? p[static_cast<size_t>(gp) * D + k] : 0.f;
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  // |q_{row0+tid}|^2 for tid < 128, else |p_{col0+tid-128}|^2
  float norm = 0.f;

  load(0);
  for (int k0 = 0; k0 < D; k0 += kBK) {
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int e = tid + i * kThreads;
      qs[e % kBK][e / kBK] = q_reg[i];
      ps[e % kBK][e / kBK] = p_reg[i];
    }
    __syncthreads();
    if (k0 + kBK < D) load(k0 + kBK);

    if (tid < kBM) {
#pragma unroll
      for (int k = 0; k < kBK; ++k) norm = fmaf(qs[k][tid], qs[k][tid], norm);
    } else {
#pragma unroll
      for (int k = 0; k < kBK; ++k) {
        const float v = ps[k][tid - kBM];
        norm = fmaf(v, v, norm);
      }
    }

#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&qs[k][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&qs[k][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&ps[k][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&ps[k][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  if (tid < kBM) qn_s[tid] = norm;
  else pn_s[tid - kBM] = norm;
  __syncthreads();

  // epilogue: (qn + pn) - 2*cross, each op rounded on its own, then the
  // clamp (a NaN passes through, as with jnp.maximum)
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = (i < 4) ? ty * 4 + i : 64 + ty * 4 + (i - 4);
    const int gq = row0 + r;
    if (gq >= Q) continue;
    const float qn = qn_s[r];
    float* out_row = out + static_cast<size_t>(gq) * B;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = h * 64 + tx * 4;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float d = __fsub_rn(__fadd_rn(qn, pn_s[c + j]),
                                  __fmul_rn(2.f, acc[i][h * 4 + j]));
        v[j] = d < 0.f ? 0.f : d;
      }
      const int gc = col0 + c;
      if (vec4 && gc + 3 < B) {
        *reinterpret_cast<float4*>(out_row + gc) =
            make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (gc + j < B) out_row[gc + j] = v[j];
      }
    }
  }
}

// q: (Q, D), p: (B, D), out: (Q, B) — f32 device buffers, contiguous; out
// 16-byte aligned (torch's allocator gives 512). Returns the cudaError_t of
// the launch (0 on success); more than 65,535 row tiles (Q > 8,388,480) is
// refused with cudaErrorInvalidValue.
extern "C" int l2_distance(const void* q, const void* p, void* out, int Q,
                           int B, int D, void* stream) {
  if (Q <= 0 || B <= 0) return 0;
  const int row_tiles = (Q + kBM - 1) / kBM;
  if (row_tiles > 65535 || D < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((B + kBN - 1) / kBN, row_tiles);
  l2_distance_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(p),
      static_cast<float*>(out), Q, B, D, B % 4 == 0);
  return static_cast<int>(cudaGetLastError());
}
