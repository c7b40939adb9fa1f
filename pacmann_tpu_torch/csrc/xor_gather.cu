// K2 and K7a-K7c: gather-XOR parity scans over the PIR database, sm_90a.
//
// K2 replaces the Pallas kernel `_hintgen_mm_kernel_s8` and its bf16
// sibling `_hintgen_mm_kernel` (pacmann_tpu/ops/xor_scan.py, reached through
// xor_hintgen_mm): out[p, b] = XOR_s db4[s, p, off[p, b, s]], where an entry
// is k rows of 128 u32 and an offset outside [0, C) is a skip (contributes
// zero). One kernel serves offline hint generation (B = T hints per
// partition) and the online server scan (B = Q sub-queries per partition).
// The three attic kernels of pacmann_tpu/ops/attic.py compute the same
// function on other layouts or with the skip mask beside the offsets:
//   K7b `_hintgen_kernel` (xor_hintgen_skip): K2's layout, skip (P, B, S);
//   K7c `_xor_kernel` (xor_scan_flat): the flat (S, C*k, 128) layout with
//       offsets and skip (B, S), i.e. K7b's index computation at P = 1;
//   K7a `_hintgen_mm_kernel_s8p` (xor_hintgen_planes): the plane-major DB
//       (S, P, 4, C, E) int8, plane b holding byte b of every u32 word.
//
// The TPU kernels select rows with one-hot int8 matrix products (or a
// gather Mosaic cannot compile) because Mosaic cannot gather rows; Hopper
// gathers directly. An output row of k*128 words is split into groups of
// G <= 4 rows (G divides k), and each (output row, group) gets one warp.
// Lane l owns 16 bytes of every 128-word row of the group, so a warp reads
// each 512-byte row as one coalesced request, walks the S chunks,
// XOR-accumulates G uint4 in registers and writes its part once. Lanes never
// exchange data. On the plane-major layout lane l reads 4 bytes of each of
// the 4 planes (a coalesced 128 bytes per plane), XORs them plane by plane
// (XOR is bytewise) and assembles its 4 words with __byte_perm at the end:
// no sign extension enters.
//
// Bound on the H100: device memory. Hint generation at SIFT1M shape reads
// 16 * 12512 * 124 entries of 1 KB, about 25 GB, with no reuse planned
// (rows are PRF-random); the 50 MB L2 catches only accidental reuse. The
// design makes every byte moved part of a full coalesced row and keeps
// the accumulator out of memory. A warp stages kUnroll chunks' offsets and
// then their rows before XOR-ing, so it has kUnroll * G loads in flight
// instead of one: the online shapes (96 or 1536 rows) have too few warps
// to hide latency otherwise. Groups of at most 4 rows cap the staged rows
// at 32 uint4 a lane whatever k is; entries over 4 rows get more warps.
// Up to 4 rows the kernels are compiled for their k (one warp a row, as
// K2 was before it took larger entries); above, k is read at run time.

#include <cstdint>
#include <cuda_runtime.h>

constexpr int kThreads = 256;   // 8 warps per block
constexpr int kUnroll = 8;      // chunks staged per step of the S loop

// Rows of 32 uint4 (K2, K7b, K7c): `base` is the lane's uint4 in the
// group's first row of entry 0 of chunk 0.
struct RowSrc {
  const uint4* base;
  size_t s_stride;   // uint4 between chunks
  size_t e_stride;   // uint4 between entries (k * 32)
  __device__ __forceinline__ const uint4* row0(int s, int off) const {
    return base + static_cast<size_t>(s) * s_stride +
           static_cast<size_t>(off) * e_stride;
  }
  __device__ __forceinline__ uint4 load(const uint4* row, int r) const {
    return __ldg(row + r * 32);
  }
};

// Byte planes (K7a): `base` is the lane's word (4 bytes) of plane 0 in the
// group's first row of entry 0 of chunk 0; a load returns the 4 planes.
struct PlaneSrc {
  const uint32_t* base;
  size_t s_stride;       // u32 between chunks
  size_t plane_stride;   // u32 between planes (C * E / 4)
  size_t e_stride;       // u32 between entries (E / 4 = k * 32)
  __device__ __forceinline__ const uint32_t* row0(int s, int off) const {
    return base + static_cast<size_t>(s) * s_stride +
           static_cast<size_t>(off) * e_stride;
  }
  __device__ __forceinline__ uint4 load(const uint32_t* row, int r) const {
    const uint32_t* q = row + r * 32;
    return make_uint4(__ldg(q), __ldg(q + plane_stride),
                      __ldg(q + 2 * plane_stride), __ldg(q + 3 * plane_stride));
  }
};

// The accumulate loop all four kernels share: XOR over the S chunks of the
// G rows named by off_row[s] (skip_row[s] != 0, or an offset outside
// [0, C), contributes zero).
template <int G, bool kSkip, class Src>
__device__ __forceinline__ void xor_rows(const Src& src,
                                         const int32_t* __restrict__ off_row,
                                         const uint8_t* __restrict__ skip_row,
                                         int S, int C, uint4 (&acc)[G]) {
#pragma unroll
  for (int r = 0; r < G; ++r) acc[r] = make_uint4(0u, 0u, 0u, 0u);
  for (int s0 = 0; s0 < S; s0 += kUnroll) {
    int32_t off[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int s = s0 + u;
      off[u] = s < S ? __ldg(off_row + s) : -1;
      if (kSkip && s < S && __ldg(skip_row + s)) off[u] = -1;
    }
    uint4 v[kUnroll][G];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool live = static_cast<uint32_t>(off[u]) <
                        static_cast<uint32_t>(C);
      const auto* row = live ? src.row0(s0 + u, off[u]) : src.base;
#pragma unroll
      for (int r = 0; r < G; ++r) {
        v[u][r] = live ? src.load(row, r) : make_uint4(0u, 0u, 0u, 0u);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int r = 0; r < G; ++r) {
        acc[r].x ^= v[u][r].x;
        acc[r].y ^= v[u][r].y;
        acc[r].z ^= v[u][r].z;
        acc[r].w ^= v[u][r].w;
      }
    }
  }
}

// One warp per (row of the (P, B) output, group of G rows of the entry).
struct WarpTask {
  long long row;   // p * B + b
  int p, group, lane;
};

__device__ __forceinline__ bool warp_task(int P, int B, int groups,
                                          WarpTask& t) {
  const long long warp =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / 32;
  if (warp >= static_cast<long long>(P) * B * groups) return false;
  t.row = groups == 1 ? warp : warp / groups;
  t.group = static_cast<int>(warp - t.row * groups);
  t.p = static_cast<int>(t.row / B);
  t.lane = threadIdx.x & 31;
  return true;
}

// K2 (kSkip = false) and K7b / K7c (kSkip = true): db (S, P, C*k, 32)
// uint4, offsets and skip (P, B, S), out (P, B, k, 32) uint4. K is k when
// an entry fits one group (k <= 4: strides known at compile time, one warp
// a row), else 0 and k is read at run time.
template <int G, int K, bool kSkip>
__global__ void __launch_bounds__(kThreads) gather_kernel(
    const uint4* __restrict__ db, const int32_t* __restrict__ offsets,
    const uint8_t* __restrict__ skip, uint4* __restrict__ out, int S, int P,
    int C, int B, int k_run) {
  const int k = K > 0 ? K : k_run;
  WarpTask t;
  if (!warp_task(P, B, K > 0 ? 1 : k / G, t)) return;
  const size_t e_stride = static_cast<size_t>(k) * 32;
  const size_t chunk = static_cast<size_t>(C) * e_stride;   // one (s, p)
  const size_t first = static_cast<size_t>(t.group) * G * 32 + t.lane;
  const RowSrc src{db + t.p * chunk + first, P * chunk, e_stride};
  uint4 acc[G];
  xor_rows<G, kSkip>(src, offsets + t.row * S,
                     kSkip ? skip + t.row * S : nullptr, S, C, acc);
  uint4* dst = out + t.row * e_stride + first;
#pragma unroll
  for (int r = 0; r < G; ++r) dst[r * 32] = acc[r];
}

// K7a: dbp (S, P, 4, C, E) int8, offsets (P, B, S) (skips folded in as any
// offset outside [0, C)), out (P, B, E) u32 as (P, B, k, 32) uint4; K as
// in gather_kernel.
template <int G, int K>
__global__ void __launch_bounds__(kThreads) plane_kernel(
    const uint32_t* __restrict__ dbp, const int32_t* __restrict__ offsets,
    uint4* __restrict__ out, int S, int P, int C, int B, int k_run) {
  const int k = K > 0 ? K : k_run;
  WarpTask t;
  if (!warp_task(P, B, K > 0 ? 1 : k / G, t)) return;
  const size_t e_stride = static_cast<size_t>(k) * 32;        // u32
  const size_t plane = static_cast<size_t>(C) * e_stride;
  const size_t first = static_cast<size_t>(t.group) * G * 32 + t.lane;
  const PlaneSrc src{dbp + t.p * 4 * plane + first, P * 4 * plane, plane,
                     e_stride};
  uint4 acc[G];
  xor_rows<G, false>(src, offsets + t.row * S, nullptr, S, C, acc);
  uint4* dst = out + t.row * e_stride + first;
#pragma unroll
  for (int r = 0; r < G; ++r) {
    // acc[r] holds planes 0-3 of the lane's words 4l..4l+3; word j takes
    // byte j of each plane, plane b as its byte b
    const uint4 a = acc[r];
    const uint32_t lo01 = __byte_perm(a.x, a.y, 0x5140);
    const uint32_t hi01 = __byte_perm(a.x, a.y, 0x7362);
    const uint32_t lo23 = __byte_perm(a.z, a.w, 0x5140);
    const uint32_t hi23 = __byte_perm(a.z, a.w, 0x7362);
    dst[r * 32] = make_uint4(__byte_perm(lo01, lo23, 0x5410),
                             __byte_perm(lo01, lo23, 0x7632),
                             __byte_perm(hi01, hi23, 0x5410),
                             __byte_perm(hi01, hi23, 0x7632));
  }
}

// Rows per warp: the whole entry up to 4 rows (so k <= 4 runs as one warp
// per output row), else the largest of 4, 3, 2 that divides k, else 1.
static int group_rows(int k) {
  if (k <= 4) return k;
  for (int g = 4; g > 1; --g) {
    if (k % g == 0) return g;
  }
  return 1;
}

static unsigned int blocks_for(long long warps) {
  return static_cast<unsigned int>((warps * 32 + kThreads - 1) / kThreads);
}

// Runs f.run<G, K>() for k: K = k up to 4 rows (one warp a row, strides
// known at compile time), else G = group_rows(k) rows a warp and K = 0.
template <class F>
static void dispatch(int k, const F& f) {
  switch (k <= 4 ? k : 4 + group_rows(k)) {
    case 1: f.template run<1, 1>(); break;
    case 2: f.template run<2, 2>(); break;
    case 3: f.template run<3, 3>(); break;
    case 4: f.template run<4, 4>(); break;
    case 5: f.template run<1, 0>(); break;
    case 6: f.template run<2, 0>(); break;
    case 7: f.template run<3, 0>(); break;
    default: f.template run<4, 0>(); break;
  }
}

struct Launch {
  unsigned int blocks;
  cudaStream_t st;
  const void* db;
  const int32_t* offsets;
  const uint8_t* skip;
  uint4* out;
  int S, P, C, B, k;
};

template <bool kSkip>
struct GatherLaunch : Launch {
  template <int G, int K>
  void run() const {
    gather_kernel<G, K, kSkip><<<blocks, kThreads, 0, st>>>(
        static_cast<const uint4*>(db), offsets, skip, out, S, P, C, B, k);
  }
};

struct PlaneLaunch : Launch {
  template <int G, int K>
  void run() const {
    plane_kernel<G, K><<<blocks, kThreads, 0, st>>>(
        static_cast<const uint32_t*>(db), offsets, out, S, P, C, B, k);
  }
};

// Fills the launch shape of a (P, B) output of k-row entries; false for k,
// C or S out of range.
static bool shape(Launch& l, const void* db, const void* offsets,
                  const void* skip, void* out, int S, int P, int C, int k,
                  int B, void* stream) {
  if (k < 1 || C < 1 || S < 0) return false;
  const long long warps =
      static_cast<long long>(P) * B * (k / group_rows(k));
  l.blocks = warps > 0 ? blocks_for(warps) : 0;
  l.st = static_cast<cudaStream_t>(stream);
  l.db = db;
  l.offsets = static_cast<const int32_t*>(offsets);
  l.skip = static_cast<const uint8_t*>(skip);
  l.out = static_cast<uint4*>(out);
  l.S = S;
  l.P = P;
  l.C = C;
  l.B = B;
  l.k = k;
  return true;
}

template <class L>
static int launch(const void* db, const void* offsets, const void* skip,
                  void* out, int S, int P, int C, int k, int B, void* stream) {
  L l;
  if (!shape(l, db, offsets, skip, out, S, P, C, k, B, stream)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (l.blocks == 0) return 0;
  dispatch(k, l);
  return static_cast<int>(cudaGetLastError());
}

// All entries below take device buffers, contiguous and 16-byte aligned,
// and return the cudaError_t of the launch (0 on success); k < 1 is refused
// with cudaErrorInvalidValue.

// K2. db (S, P, C*k, 128) int32; offsets (P, B, S) int32; out (P, B, k*128).
extern "C" int xor_gather(const void* db, const void* offsets, void* out,
                          int S, int P, int C, int k, int B, void* stream) {
  return launch<GatherLaunch<false>>(db, offsets, nullptr, out, S, P, C, k, B,
                                     stream);
}

// K7b. db (S, P, C*k, 128) int32; offsets (P, B, S) int32, skip (P, B, S)
// bool; out (P, B, k, 128).
extern "C" int xor_hintgen_skip(const void* db, const void* offsets,
                                const void* skip, void* out, int S, int P,
                                int C, int k, int B, void* stream) {
  return launch<GatherLaunch<true>>(db, offsets, skip, out, S, P, C, k, B,
                                    stream);
}

// K7c. db (S, C*k, 128) int32; offsets and skip (B, S); out (B, k, 128):
// the flat layout is K7b's at P = 1.
extern "C" int xor_scan_flat(const void* db, const void* offsets,
                             const void* skip, void* out, int S, int C, int k,
                             int B, void* stream) {
  return launch<GatherLaunch<true>>(db, offsets, skip, out, S, 1, C, k, B,
                                    stream);
}

// K7a. dbp (S, P, 4, C, k*128) int8; offsets (P, B, S) int32 with skips as
// any offset outside [0, C); out (P, B, k*128) int32.
extern "C" int xor_hintgen_planes(const void* dbp, const void* offsets,
                                  void* out, int S, int P, int C, int k,
                                  int B, void* stream) {
  return launch<PlaneLaunch>(dbp, offsets, nullptr, out, S, P, C, k, B,
                             stream);
}
