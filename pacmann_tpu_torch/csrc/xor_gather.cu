// K2 and K7a-K7c: gather-XOR parity scans over the PIR database, sm_90a.
//
// K2 replaces the Pallas kernel `_hintgen_mm_kernel_s8` and its bf16
// sibling `_hintgen_mm_kernel` (pacmann_tpu/ops/xor_scan.py, reached through
// xor_hintgen_mm): out[p, b] = XOR_s db4[s, p, off[p, b, s]], where an entry
// is k rows of 128 u32 and an offset outside [0, C) is a skip (contributes
// zero). It serves offline hint generation (B = T hints per partition) and
// the online server scan (B = Q sub-queries per partition), in two forms
// that ops/xor_scan.py::gather_form chooses between by shape:
//
//   chunk-major (B >= 16C and C <= 512, hint generation): a CTA owns
//     partition p, a block of up to kCmHints hints and a 64-byte column
//     slice of the entry. It walks the S chunks; each chunk's slice (C rows
//     x 64 B) is staged in shared memory by cp.async in a kCmStages-deep
//     ring, and every 4 lanes XOR one hint's row out of shared memory into
//     registers, 16 bytes each. Bound on the H100: at SIFT1M shape the
//     gathers read each chunk row T/C ~ 24 times, which the warp-per-row
//     form serves from L2 (25 GB through L2 -> SM for a 1.04 GB DB). Here
//     the DB crosses L2 -> SM once per hint block (5 x 1.04 GB) and the
//     offsets once per column slice (16 x 99 MB), and the gather happens
//     in shared memory: one 16-byte read per (hint, chunk, 16 B of entry),
//     a quarter-warp reading two random 64-byte rows (1.5 wavefronts on
//     average). Offsets are copied as each hint's runs of 8 chunks (32
//     bytes of its (P, B, S) row) and kept in shared memory as packed
//     16-bit row indices, a skip as the zero row kept at index C.
//   row-split (few rows per partition, the server scan): W warps share an
//     output row (and group of at most 4 of its 128-word rows), warp w
//     walking chunks w*8.., (w+W)*8.., and the W partial sums are XORed in
//     shared memory. W is chosen by the caller so that few rows still give
//     the card enough warps (W = 1: one warp a row).
//
// The three attic kernels of pacmann_tpu/ops/attic.py compute the same
// function on other layouts or with the skip mask beside the offsets, and
// keep the warp-per-row form (gather_kernel, plane_kernel):
//   K7b `_hintgen_kernel` (xor_hintgen_skip): K2's layout, skip (P, B, S);
//   K7c `_xor_kernel` (xor_scan_flat): the flat (S, C*k, 128) layout with
//       offsets and skip (B, S), i.e. K7b's index computation at P = 1;
//   K7a `_hintgen_mm_kernel_s8p` (xor_hintgen_planes): the plane-major DB
//       (S, P, 4, C, E) int8, plane b holding byte b of every u32 word.
//
// The TPU kernels select rows with one-hot int8 matrix products (or a
// gather Mosaic cannot compile) because Mosaic cannot gather rows; Hopper
// gathers directly. In the warp-per-row form an output row of k*128 words
// is split into groups of G <= 4 rows (G divides k), and each (output row,
// group) gets one warp (W warps in the row-split form). Lane l owns 16
// bytes of every 128-word row of the group, so a warp reads each 512-byte
// row as one coalesced request, walks the S chunks, XOR-accumulates G uint4
// in registers and writes its part once. On the plane-major layout lane l
// reads 4 bytes of each of the 4 planes (a coalesced 128 bytes per plane),
// XORs them plane by plane (XOR is bytewise) and assembles its 4 words with
// __byte_perm at the end: no sign extension enters. A warp stages kUnroll
// chunks' offsets and then their rows before XOR-ing, so it has
// kUnroll * G loads in flight instead of one. Up to 4 rows the kernels are
// compiled for their k; above, k is read at run time.

#include <cstdint>
#include <cuda_runtime.h>

#include "cp_async.cuh"

constexpr int kThreads = 256;   // 8 warps per block (warp-per-row forms)
constexpr int kUnroll = 8;      // chunks staged per step of the S loop
constexpr int kMaxSplit = kThreads / 32;   // row-split: warps per row
constexpr int kCmThreads = 512;  // chunk-major: threads per CTA
constexpr int kCmHints = 3072;   // chunk-major: hints per CTA
constexpr int kCmLanes = 4;      // chunk-major: lanes (uint4) per hint
constexpr int kCmStages = 2;     // chunk-major: chunks in flight
constexpr int kCmRun = 8;        // chunk-major: chunks per offset load

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

// The accumulate loop all the warp-per-row kernels share: XOR over the
// chunks s0 + u (s0 = first, first + step, ...; u < kUnroll; s < S) of the
// G rows named by off_row[s] (skip_row[s] != 0, or an offset outside
// [0, C), contributes zero).
template <int G, bool kSkip, class Src>
__device__ __forceinline__ void xor_rows(const Src& src,
                                         const int32_t* __restrict__ off_row,
                                         const uint8_t* __restrict__ skip_row,
                                         int S, int C, uint4 (&acc)[G],
                                         int first = 0, int step = kUnroll) {
#pragma unroll
  for (int r = 0; r < G; ++r) acc[r] = make_uint4(0u, 0u, 0u, 0u);
  for (int s0 = first; s0 < S; s0 += step) {
    int32_t off[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int s = s0 + u;
      // one conditional block: as two guarded loads of off[u], ptxas
      // spilled a register in the k = 2 skip-mask kernel
      int32_t o = -1;
      if (s < S) {
        o = __ldg(off_row + s);
        if (kSkip && __ldg(skip_row + s)) o = -1;
      }
      off[u] = o;
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

__device__ __forceinline__ void xor_into(uint4& acc, const uint4 v) {
  acc.x ^= v.x;
  acc.y ^= v.y;
  acc.z ^= v.z;
  acc.w ^= v.w;
}

// K2, row-split form: W warps (W divides kMaxSplit) per (row of the (P, B)
// output, group of G rows), kMaxSplit / W such tasks a block; warp w of a
// task takes the chunks w*kUnroll + j*W*kUnroll + u. db, offsets, out and
// K as in gather_kernel.
template <int G, int K>
__global__ void __launch_bounds__(kThreads) row_split_kernel(
    const uint4* __restrict__ db, const int32_t* __restrict__ offsets,
    uint4* __restrict__ out, int S, int P, int C, int B, int k_run, int W) {
  __shared__ uint4 part[kMaxSplit][G][32];
  const int k = K > 0 ? K : k_run;
  const int groups = K > 0 ? 1 : k / G;
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const long long task =
      static_cast<long long>(blockIdx.x) * (kMaxSplit / W) + warp / W;
  const int w = warp % W;
  const bool valid = task < static_cast<long long>(P) * B * groups;
  const long long row = groups == 1 ? task : task / groups;
  const size_t e_stride = static_cast<size_t>(k) * 32;
  const size_t first =
      static_cast<size_t>(task - row * groups) * G * 32 + lane;
  uint4 acc[G];
  if (valid) {
    const size_t chunk = static_cast<size_t>(C) * e_stride;
    const int p = static_cast<int>(row / B);
    const RowSrc src{db + p * chunk + first, P * chunk, e_stride};
    xor_rows<G, false>(src, offsets + row * S, nullptr, S, C, acc,
                       w * kUnroll, W * kUnroll);
  }
  if (W > 1) {
    if (valid) {
#pragma unroll
      for (int r = 0; r < G; ++r) part[warp][r][lane] = acc[r];
    }
    __syncthreads();
    if (!valid || w != 0) return;
    for (int v = 1; v < W; ++v) {
#pragma unroll
      for (int r = 0; r < G; ++r) xor_into(acc[r], part[warp + v][r][lane]);
    }
  } else if (!valid) {
    return;
  }
  uint4* dst = out + row * e_stride + first;
#pragma unroll
  for (int r = 0; r < G; ++r) dst[r * 32] = acc[r];
}

// K2, chunk-major form: CTA (slice c of kCmLanes uint4, hint block of
// nb <= kCmHints hints from b0, partition p). Lane t % kCmLanes of thread t
// owns that uint4 (a "piece") of hint i * kSlot + t / kCmLanes, i < kSlots.
// Dynamic shared memory, in order: kCmStages stages of C + 1 rows of
// kCmLanes uint4 (row C is zero); the run's offsets as loaded, kCmHints x
// kCmRun int32 [hint][chunk]; the run's packed row indices, kCmRun / 2 x
// kCmHints words [pair of chunks][hint]. db (S, P, C*k, 32) uint4, offsets
// (P, B, S), out (P, B, k, 32) uint4; vec_off: offset rows can be copied
// 16 bytes at a time (S % 4 == 0, 16-byte aligned).
__global__ void __launch_bounds__(kCmThreads, 1) chunk_major_kernel(
    const uint4* __restrict__ db, const int32_t* __restrict__ offsets,
    uint4* __restrict__ out, int S, int P, int C, int B, int k, int hb,
    bool vec_off) {
  constexpr int L = kCmLanes;
  constexpr int kSlot = kCmThreads / L;          // hints per slot
  constexpr int kSlots = kCmHints / kSlot;       // slots a thread
  extern __shared__ uint4 smem[];
  const int tid = threadIdx.x;
  const int c = blockIdx.x;
  const int b0 = blockIdx.y * hb;
  const int p = blockIdx.z;
  const int nb = min(hb, B - b0);
  const int piece = tid % L, own = tid / L;
  const size_t e4 = static_cast<size_t>(k) * 32;   // uint4 per entry
  const size_t stage = (static_cast<size_t>(C) + 1) * L;
  uint4* ring = smem;
  int32_t* raw = reinterpret_cast<int32_t*>(smem + kCmStages * stage);
  uint32_t* runs = reinterpret_cast<uint32_t*>(raw + kCmHints * kCmRun);
  const uint4* base = db + static_cast<size_t>(p) * C * e4 + c * L;
  const size_t s_stride = static_cast<size_t>(P) * C * e4;
  const int32_t* off0 = offsets + (static_cast<size_t>(p) * B + b0) * S;

  for (int z = tid; z < kCmStages * L; z += kCmThreads) {
    ring[(z / L) * stage + static_cast<size_t>(C) * L + z % L] =
        make_uint4(0u, 0u, 0u, 0u);
  }
  // chunk s's slice into its stage: thread e copies piece e % L of row e / L
  auto issue = [&](int s) {
    uint4* dst = ring + (s % kCmStages) * stage;
    const uint4* src = base + s * s_stride;
    for (int e = tid; e < C * L; e += kCmThreads) {
      cp_async16(dst + e, src + (e / L) * e4 + e % L, 16);
    }
  };
  // offsets of chunks s0 .. s0 + kCmRun - 1 of the block's hints into raw
  // (entries past S or nb are left as they fall: the packing masks them)
  auto issue_run = [&](int s0) {
    for (int e = tid; e < kCmHints * kCmRun / 4; e += kCmThreads) {
      const int h = e / (kCmRun / 4), q = 4 * (e % (kCmRun / 4));
      const int32_t* src = off0 + static_cast<size_t>(h) * S + s0 + q;
      int32_t* dst = raw + h * kCmRun + q;
      if (vec_off) {
        const bool ok = h < nb && s0 + q < S;
        cp_async16(dst, ok ? src : offsets, ok ? 16 : 0);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool ok = h < nb && s0 + q + j < S;
          cp_async4(dst + j, ok ? src + j : offsets, ok ? 4 : 0);
        }
      }
    }
  };
  issue_run(0);
  for (int s = 0; s < kCmStages - 1; ++s) {
    if (s < S) issue(s);
    cp_async_commit();
  }

  uint4 acc[kSlots];
#pragma unroll
  for (int i = 0; i < kSlots; ++i) acc[i] = make_uint4(0u, 0u, 0u, 0u);
  const uint32_t C32 = static_cast<uint32_t>(C);
  for (int s0 = 0; s0 < S; s0 += kCmRun) {
#pragma unroll
    for (int u = 0; u < kCmRun; ++u) {
      const int s = s0 + u;
      if (s >= S) break;
      cp_async_wait<kCmStages - 2>();   // chunk s has landed (this thread)
      __syncthreads();   // ... for every thread; chunk s - 1 is done
      if (u == 0) {
        // the run's row indices, two to a word, C for a skip (or a chunk
        // past S, or a hint past nb); then the next run's offsets
        for (int h = tid; h < kCmHints; h += kCmThreads) {
          const int32_t* o = raw + h * kCmRun;
#pragma unroll
          for (int q = 0; q < kCmRun / 2; ++q) {
            uint32_t lo = static_cast<uint32_t>(o[2 * q]);
            uint32_t hi = static_cast<uint32_t>(o[2 * q + 1]);
            lo = (h < nb && s0 + 2 * q < S && lo < C32) ? lo : C32;
            hi = (h < nb && s0 + 2 * q + 1 < S && hi < C32) ? hi : C32;
            runs[q * kCmHints + h] = lo | (hi << 16);
          }
        }
        __syncthreads();
        if (s0 + kCmRun < S) issue_run(s0 + kCmRun);
      }
      if (s + kCmStages - 1 < S) issue(s + kCmStages - 1);
      cp_async_commit();
      const uint4* rows = ring + (s % kCmStages) * stage + piece;
      const uint32_t* pair = runs + (u / 2) * kCmHints + own;
#pragma unroll
      for (int i = 0; i < kSlots; ++i) {
        if (i * kSlot < nb) {
          const uint32_t r = (pair[i * kSlot] >> ((u & 1) * 16)) & 0xFFFFu;
          xor_into(acc[i], rows[r * L]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    const int h = i * kSlot + own;
    if (h < nb) {
      out[(static_cast<size_t>(p) * B + b0 + h) * e4 + c * L + piece] =
          acc[i];
    }
  }
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

struct RowSplitLaunch : Launch {
  int W;
  template <int G, int K>
  void run() const {
    row_split_kernel<G, K><<<blocks, kThreads, 0, st>>>(
        static_cast<const uint4*>(db), offsets, out, S, P, C, B, k, W);
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

// K2, both forms: db (S, P, C*k, 128) int32; offsets (P, B, S) int32;
// out (P, B, k*128) int32.

// The row-split form with W warps a row (W in 1, 2, 4, 8).
extern "C" int xor_gather_row_split(const void* db, const void* offsets,
                                    void* out, int S, int P, int C, int k,
                                    int B, int W, void* stream) {
  RowSplitLaunch l;
  if (W < 1 || W > kMaxSplit || kMaxSplit % W != 0 ||
      !shape(l, db, offsets, nullptr, out, S, P, C, k, B, stream)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  l.W = W;
  const long long tasks =
      static_cast<long long>(P) * B * (k / group_rows(k));
  l.blocks = tasks > 0 ? blocks_for(tasks * W) : 0;
  if (l.blocks == 0) return 0;
  dispatch(k, l);
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory of the chunk-major form: the ring of C + 1 rows,
// the run's offsets and the packed run.
static int chunk_major_smem(int C) {
  return kCmStages * (C + 1) * kCmLanes * static_cast<int>(sizeof(uint4)) +
         kCmHints * kCmRun * static_cast<int>(sizeof(int32_t)) +
         kCmRun / 2 * kCmHints * static_cast<int>(sizeof(uint32_t));
}

// The chunk-major form. Refuses (cudaErrorInvalidValue) C >= 65,535 (the
// packed 16-bit row index) and a ring larger than the device's opt-in
// shared memory (C above 663 on an H100).
extern "C" int xor_gather_chunk_major(const void* db, const void* offsets,
                                      void* out, int S, int P, int C, int k,
                                      int B, void* stream) {
  if (k < 1 || C < 1 || C >= 0xFFFF || S < 0 || P < 0 || B < 0 ||
      P > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (P == 0 || B == 0) return 0;
  const int smem = chunk_major_smem(C);
  int dev = 0, limit = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess) {
    rc = cudaDeviceGetAttribute(
        &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (smem > limit) return static_cast<int>(cudaErrorInvalidValue);
  static int opted = 48 * 1024;   // the size every kernel may use unasked
  if (smem > opted) {
    rc = cudaFuncSetAttribute(chunk_major_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    opted = smem;
  }
  const int blocks = (B + kCmHints - 1) / kCmHints;
  const int hb = (B + blocks - 1) / blocks;   // balanced hint blocks
  if (blocks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec_off =
      S % 4 == 0 && reinterpret_cast<uintptr_t>(offsets) % 16 == 0;
  chunk_major_kernel<<<dim3(k * 32 / kCmLanes, blocks, P), kCmThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(db), static_cast<const int32_t*>(offsets),
      static_cast<uint4*>(out), S, P, C, B, k, hb, vec_off);
  return static_cast<int>(cudaGetLastError());
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
