// K2 and K7a-K7c: gather-XOR parity scans over the PIR database, sm_90a.
//
// K2 replaces the Pallas kernel `_hintgen_mm_kernel_s8` and its bf16
// sibling `_hintgen_mm_kernel` (pacmann_tpu/ops/xor_scan.py, reached through
// xor_hintgen_mm): out[p, b] = XOR_s db4[s, p, off[p, b, s]], where an entry
// is k rows of 128 u32 and an offset outside [0, C) is a skip (contributes
// zero). It serves offline hint generation (B = T hints per partition) and
// the online server scan (B = Q sub-queries per partition), in three forms
// that ops/xor_scan.py::gather_form chooses between by shape:
//
//   chunk-major (B >= 16C and C <= 512, hint generation): staged_kernel
//     (below) with 64-byte column slices, 4 lanes and 2,560 hints a CTA.
//     Bound on the H100: at SIFT1M shape the gathers read each chunk row
//     T/C ~ 24 times, which a warp-per-row form serves from L2 (25 GB
//     through L2 -> SM for a 1.04 GB DB). Staged, the DB crosses L2 -> SM
//     once per hint block (5 x 1.04 GB) and the offsets once per column
//     slice (16 x 99 MB), and the gather happens in shared memory: one
//     16-byte read per (hint, chunk, 16 B of entry), a quarter-warp
//     reading two random 64-byte rows (1.5 wavefronts on average).
//   sliced (B >= 2C and C > 512, hint generation whose chunks the chunk
//     form's ring cannot hold): sliced_row_split_kernel (below). A CTA owns
//     one partition, one 128-byte column slice of the entries (one cache
//     line of a 512-byte row; 4k slices an entry) and 256 hints: 8 lanes of
//     16 bytes a hint, 8 hints a thread, each hint's XOR in registers. The
//     grid is (hint block, partition, slice), so the CTAs resident together
//     gather one (partition, slice) of every chunk, walking the chunks in
//     the same order: 4 CTAs an SM (64 registers, no spill), 135,168 hints
//     on the card, 75 % of a partition's T = 179,584 at the SIFT100M
//     shard's prep (P = 4, S = 764, C = 8,192, k = 2). A chunk's slice is
//     C x 128 B = 1 MB, so the lines the hints of a wave name come from HBM
//     about once and from L2 to the other ~21 hints that name them. Bound
//     on the H100 at that shape: gather_bound 8.53 ms (each named entry
//     read once); the kernel reads ~75 GB from HBM (the DB's slices about
//     2.3 times, once for each wave that covers a (partition, slice), the
//     offsets once a slice: 8 x 2.2 GB, the 0.74 GB out), ~22 ms at
//     3.35 TB/s, but moves 4 x 179,584 x 764 x 1 KB = 562 GB of gathered
//     lines from L2 to the SMs: L2's rate sets its time. On an H100 (700
//     W; uniform DB, K1's table with the skip mask): the shard's prep 78.5
//     ms (7.16 TB/s of gathered lines; the row form 177.8, 3.16 TB/s from
//     HBM), bench's BIG prep (16, 24,416, 196), C = 1,024: 7.86 (row
//     19.41), the 5M prep (16, 35,552, 156), C = 2,048: 10.25 (row 25.68).
//     At uniform offsets it is 3-18 % faster than the row form at B = C
//     and 33-34 % at 2C (C = 8,192 and 1,024), hence the switch at 2C; at
//     C = 512 it beat the chunk form (2.20 against 2.72 ms at 24C), which
//     gather_form still takes there. Tried, shard / BIG / 5M in ms: 12
//     hints a thread with 2 CTAs an SM (126 registers) 202 / 20.7 / 27.5,
//     16 with 2 166.8 / 20.5 / 26.2, 8 with 3 126.9 / 12.5 / 17.1: below
//     32 warps an SM too few gathers are in flight. The offsets loaded one
//     run ahead (16 more registers): 8 with 4 92.0 / 10.9 / 14.3; without,
//     those registers carry gathers: 78.5 / 7.86 / 10.25, and 9 with 4
//     79.6, 6 with 5 81.3, 5 with 6 82.8 at the shard. 4 hints with 8
//     CTAs, 6 with 6, 20 in 512-thread CTAs and a 32-bit entry index
//     spill, and lose (96-346 ms); the DB's lines by ld.global.cg, the
//     offsets by ld.global.cs, and an L2 evict_last policy on the DB's
//     lines each moved the shard's time by 3 % or less.
//   row-split (few rows per partition, the server scan): W warps share an
//     output row (and group of at most 4 of its 128-word rows), warp w
//     walking chunks w*8.., (w+W)*8.., and the W partial sums are XORed in
//     shared memory. W is chosen by the caller so that few rows still give
//     the card enough warps (W = 1: one warp a row).
//
// The three attic kernels of pacmann_tpu/ops/attic.py compute the same
// function on other layouts or with the skip mask beside the offsets:
//   K7b `_hintgen_kernel` (xor_hintgen_skip): K2's layout, skip (P, B, S);
//   K7c `_xor_kernel` (xor_scan_flat): the flat (S, C*k, 128) layout with
//       offsets and skip (B, S), i.e. K7b's index computation at P = 1;
//   K7a `_hintgen_mm_kernel_s8p` (xor_hintgen_planes): the plane-major DB
//       (S, P, 4, C, E) int8, plane b holding byte b of every u32 word.
// K7a-K7c each have two forms, chosen by ops/attic.py (plane_form,
// hintgen_form, flat_form) by shape: the staged form where many hints share
// a chunk's rows, else the warp-per-row form (plane_kernel, gather_kernel).
// Their warp-per-row forms read a row from L2 for every (hint, chunk):
// ~22-25 GB, at ~6 TB/s through L2 -> SM, 3.1-3.9 ms against a bound of
// 0.37-0.41.
//
//   K7b staged (B >= 16C, C <= 512): K2's chunk geometry (64-byte column
//     slices, 4 lanes, 2,560 hints a CTA, cp.async fills), fed as K7c is:
//     index_kernel first folds the mask into the offsets and writes (P, S,
//     Bp) uint16 row indices (C for a skip or an offset outside [0, C); 99
//     MB of offsets and 25 MB of mask read, 50 MB written at SIFT1M's
//     shape, k = 2), and every stage copies its chunk's indices for the
//     block (5 KB, contiguous) beside the rows. No offset runs and no
//     packing: the stage holds 76 KB at C = 512 (C above 1,735 refused).
//     On an H100 (700 W) at (16, 12,512, 124): 2.27 ms at k = 2 (row form
//     3.08, K2's chunk form 2.72) and 5.63 at k = 5 (K2's 6.81). K2's runs
//     read each hint's 8 offsets of a run at a 496-byte stride; the mask's
//     8 bytes beside them, at a 124-byte stride, cost a 32-byte sector
//     each and doubled the run's copies: that form (the mask copied into
//     the runs, packed as row C) took 3.20 ms, above the row form.
//
//   K7a staged (B >= 16C, C <= 512): the planes' XORs are bytewise, so a
//     CTA owns 128 bytes of one plane's rows (a whole cache line a row:
//     slice c is plane c / k, bytes 128 (c % k) ..), 8 lanes and 1,280
//     hints a CTA; a hint's row is one 128-byte phase of its 8 lanes, one
//     wavefront with no bank conflict. The TMA engine fills a stage: boxes
//     of up to 256 rows x 128 bytes cut from a 3-D tensor map over the
//     planes, issued by one thread. Its output, each row's 4 planes, goes
//     to scratch, and plane_words_kernel assembles the words (205 MB read
//     and written at SIFT1M's shape) with __byte_perm: no sign extension
//     enters. At (16, 12,512, 124), k = 2: 8 slices x 10 hint blocks x 16
//     partitions = 1,280 CTAs (193 KB of shared memory, one an SM);
//     gathers 16 x 12,512 x 124 x 8 = 199 M wavefronts; fills 1,280 x 124
//     x 512 rows x 128 B = 10.4 GB through L2 -> SM in 512 lines a chunk,
//     81 M store wavefronts: ~280 M wavefronts over 132 SMs at 1.98 GHz, a
//     shared-memory floor of ~1.07 ms (bound 0.40: the bytes). Staging 32
//     bytes of all 4 planes instead (a 128-byte row of 32 whole words)
//     touched 2,048 lines a chunk, and took 3.5 ms; the same stages filled
//     by every thread's cp.async took 2.49 ms, by the TMA engine 2.39.
//   K7c staged (B >= 20C, C <= 3,072): 32-byte rows, 2 lanes and 5,120
//     hints a CTA: a stage is C x 32 B (64 KB at C = 2,048; 64-byte rows
//     would need 262 KB for two stages). A 32-byte piece of 1 KB entries
//     is a line of its own, so the entry point first copies the DB slice-
//     major (slice_major_kernel: 1.03 GB read and written), and a stage is
//     then one bulk copy by the TMA engine of the slice's 64 KB, with the
//     chunk's 16-bit row indices beside it (index_kernel writes them
//     from the (B, S) offsets and skip: 141 MB read, 57 MB written). At B
//     = 57,632, S = 492, C = 2,048, k = 2, skip 25 %: 12 hint blocks x 32
//     slices = 384 CTAs (151 KB); a quarter-warp phase carries 4 hints'
//     random 32-byte rows (a skip reads the zero row C), ~2.1 wavefronts,
//     so gathers take 57,632 x 492 / 4 x 32 x 2.1 = ~476 M wavefronts,
//     fills 384 x 492 x 75 KB = 14 GB L2 -> SM and 97 M store wavefronts:
//     ~570 M wavefronts, a floor of ~2.2 ms (chip_smoke.py counts 2.15 on
//     its input; bound 0.37). The grid is hint-block-major: the 12 CTAs
//     staging one slice run together, so each slice of a chunk comes from
//     DRAM once and from L2 to the other eleven. Filled by cp.async from
//     the original layout (2,048 lines a chunk) it took 4.2-4.7 ms; from
//     the slice-major copy by cp.async 3.9, by bulk copies 3.1 (with both
//     passes); by 32-byte boxes of a tensor map over the original layout
//     (no copy) 4.04, thread 0 stalling on issuing 8 boxes a chunk. With
//     the stages 128-byte aligned, thread 0 of CTA 0 spends 81 % of its
//     clocks gathering and 6 % waiting for a stage, and the kernel alone
//     takes 2.33 ms against the 2.15 its wavefronts need: the gathers'
//     bank conflicts bound it. A third stage changed nothing (3.15
//     against 3.12 ms), and a bulk copy multicast to a cluster of hint
//     blocks, which would halve the fills' L2 reads, is not taken.

// The TPU kernels select rows with one-hot int8 matrix products (or a
// gather Mosaic cannot compile) because Mosaic cannot gather rows; Hopper
// gathers directly. In the warp-per-row form an output row of k*128 words
// is split into groups of G <= 4 rows (G divides k), and each (output row,
// group) gets one warp (W warps in the row-split form). Lane l owns 16
// bytes of every 128-word row of the group, so a warp reads each 512-byte
// row as one coalesced request, walks the S chunks, XOR-accumulates G uint4
// in registers and writes its part once. On the plane-major layout lane l
// reads 4 bytes of each of the 4 planes (a coalesced 128 bytes per plane),
// XORs them plane by plane and assembles its 4 words at the end. A warp
// stages kUnroll chunks' offsets and then their rows before XOR-ing, so it
// has kUnroll * G loads in flight instead of one. Up to 4 rows the kernels
// are compiled for their k; above, k is read at run time.

#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

#include "cp_async.cuh"

constexpr int kThreads = 256;   // 8 warps per block (warp-per-row forms)
constexpr int kUnroll = 8;      // chunks staged per step of the S loop
constexpr int kMaxSplit = kThreads / 32;   // row-split: warps per row

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

// K2, sliced form: CTA (hint block, partition p, column slice c) of
// kSlThreads threads; lane t % kSlLanes of thread t owns 16 bytes of the
// slice's 128 (uint4 c * kSlLanes + t % kSlLanes of an entry), for the
// hints i * kSlSlots + t / kSlLanes of the block, i < kSlHints. At each run
// of kSlLanes chunks the lanes of a hint load one offset each (lane j:
// chunk s0 + j, -1 past S or the block), and each chunk's offset is
// shuffled to the hint's lanes; every hint's XOR sits in registers. db,
// offsets and out as in gather_kernel, k at run time.
constexpr int kSlThreads = 256;   // threads per CTA (sliced form)
constexpr int kSlLanes = 8;       // lanes a hint: 8 x 16 B, one 128-B line
constexpr int kSlHints = 8;       // hints (uint4 accumulators) a thread
constexpr int kSlMinBlocks = 4;   // CTAs an SM: 64 registers a thread
constexpr int kSlSlots = kSlThreads / kSlLanes;   // hints a slot
constexpr int kSlBlock = kSlSlots * kSlHints;     // hints a CTA

__global__ void __launch_bounds__(kSlThreads, kSlMinBlocks)
    sliced_row_split_kernel(const uint4* __restrict__ db,
                            const int32_t* __restrict__ offsets,
                            uint4* __restrict__ out, int S, int P, int C,
                            int B, int k, int hb) {
  const int b0 = blockIdx.x * hb, p = blockIdx.y, c = blockIdx.z;
  const int nb = min(hb, B - b0);
  if (nb <= 0) return;
  const int lane = threadIdx.x % kSlLanes, slot = threadIdx.x / kSlLanes;
  // the warp lane that holds chunk s0 + u's offset of this thread's hints
  const int src = threadIdx.x & 31 & ~(kSlLanes - 1);
  const int e = k * 32;   // uint4 an entry
  const size_t s_stride = static_cast<size_t>(P) * C * e;
  const uint4* base = db + static_cast<size_t>(p) * C * e + c * kSlLanes +
                      lane;
  const int32_t* off0 =
      offsets + (static_cast<size_t>(p) * B + b0) * S + lane;
  uint4 acc[kSlHints];
#pragma unroll
  for (int i = 0; i < kSlHints; ++i) acc[i] = make_uint4(0u, 0u, 0u, 0u);
  for (int s0 = 0; s0 < S; s0 += kSlLanes) {
    int32_t off[kSlHints];
#pragma unroll
    for (int i = 0; i < kSlHints; ++i) {
      const int h = i * kSlSlots + slot;
      off[i] = h < nb && s0 + lane < S
                   ? __ldg(off0 + static_cast<size_t>(h) * S + s0)
                   : -1;
    }
#pragma unroll
    for (int u = 0; u < kSlLanes; ++u) {
      const uint4* chunk = base + static_cast<size_t>(s0 + u) * s_stride;
#pragma unroll
      for (int i = 0; i < kSlHints; ++i) {
        const int32_t o = __shfl_sync(0xFFFFFFFFu, off[i], src | u);
        if (static_cast<uint32_t>(o) < static_cast<uint32_t>(C)) {
          xor_into(acc[i], __ldg(chunk + static_cast<size_t>(o) * e));
        }
      }
    }
  }
  uint4* dst = out + (static_cast<size_t>(p) * B + b0) * e + c * kSlLanes +
               lane;
#pragma unroll
  for (int i = 0; i < kSlHints; ++i) {
    const int h = i * kSlSlots + slot;
    if (h < nb) dst[h * e] = acc[i];
  }
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

// The staged (chunk-major) gather that K2's chunk form, K7a and K7c share.
// A CTA owns (column slice c of L uint4 pieces, hint block of nb <= kHints
// hints from b0, partition p). Lane t % L of thread t owns piece t % L of
// hint i * kSlot + t / L, i < kStSlots (kSlot = kStThreads / L hints a
// slot, kHints = kStSlots * kSlot). It walks the S chunks; each chunk's
// slice (C rows of L pieces) is staged in shared memory in a
// kStStages-deep ring, and every hint's L lanes XOR its row out of shared
// memory into registers, 16 bytes each, then write it to out (P, B, 32k)
// uint4 at the slice's place. Row C of every stage is zero: a skip, an
// offset outside [0, C) and a hint past nb read it.
//   The source and the fill (Fill, below): K2 copies each row's piece by
//     every thread's cp.async from the (S, P, C*k, 32) uint4 DB (L = 4);
//     K7a takes boxes of one byte plane of the (S, P, 4, C, k*128) planes
//     by the TMA engine (L = 8, 128 bytes of one plane: the CTA's out is
//     that plane's bytes, which plane_words_kernel assembles into words);
//     K7c one bulk copy of its slice of the slice-major copy
//     slice_major_kernel writes (L = 2). TMA fills complete on an mbarrier
//     a stage.
//   The offsets and the grid: K2 and K7a take the (P, B, S) int32 offsets,
//     copied as each hint's runs of kStRun chunks and packed two 16-bit
//     row indices a word. K7b and K7c (kIdx) take the (P, S, Bp) uint16
//     row indices index_kernel writes (the skip mask folded in), copied
//     with each chunk's rows into the same stage (K7b by cp.async, K7c by
//     the bulk copy). The grid's x is the slice, but with kHintMajor (K7c)
//     the hint block, so the CTAs that stage one slice are launched
//     together and share its chunks through L2.
// Dynamic shared memory, in order: kStStages stages of stage_rows (C + 1,
// or all the rows the boxes write) rows of L uint4 (then, with kIdx, the
// block's uint16 row indices, hb rounded up to a slot), each to a multiple
// of 128 bytes; without kIdx the run's offsets as loaded, kHints x kStRun
// int32 [hint][chunk], and the packed run, kStRun / 2 x kHints words
// [pair of chunks][hint]; with TMA fills an mbarrier a stage.
constexpr int kStThreads = 512;   // threads per CTA
constexpr int kStSlots = 20;      // hints (uint4 accumulators) a thread
constexpr int kStStages = 2;      // chunks in flight
constexpr int kStRun = 8;         // chunks per offset load (not kIdx)

// How a stage is filled: every thread copies its piece of each row by
// cp.async (K2); one bulk copy of a contiguous slice (K7c); or boxes of a
// 3-D tensor map (row bytes, rows, planes) that the TMA engine cuts out of
// the DB as it lies (K7a).
enum Fill { kCpAsync, kBulk, kTensor };

struct StagedArgs {
  CUtensorMap map;          // kTensor: (row bytes, C, planes of C rows)
  int box_rows;             // kTensor: rows a box (C or 256)
  int planes;               // kTensor: planes a (chunk, partition)
  int stage_rows;           // rows a stage holds (C + 1, or the boxes')
  const uint4* db;
  // piece j of slice c of row r of chunk s, partition p is db[s * P * part
  // + p * part + (c / spp) * plane + (c % spp) * slice + r * row + j]: the
  // strides in uint4, spp slices a plane
  size_t row, slice, plane, part;
  int spp;
  const int32_t* offsets;   // (P, B, S), not kIdx
  const uint16_t* idx;      // (P, S, Bp), kIdx
  uint4* out;               // (P, B, k*32) uint4
  int S, P, C, B, k, hb, Bp;
  bool vec_off;             // offset rows copy 16 bytes at a time
};

#ifdef XOR_PHASE_CLOCKS
// Built only to time the staged form's phases (scripts/kernel_ab.py
// --phases): thread 0 of CTA (0, 0, 0) sums the SM clocks (clock64) it
// spends in each phase: 0 waiting for a stage (the copies' wait and the
// barrier), 1 packing and issuing the offset runs, 2 issuing the next
// chunk's copies (and the set-up before the loop), 3 the gathers, 4 the
// epilogue; 5 is the whole kernel. The sums live in shared memory, so that
// the marks hold no registers across the loop.
__device__ unsigned long long xor_clocks[6];
#define XOR_CLOCK_INIT()                                                  \
  __shared__ unsigned long long clk_sum[6];                               \
  const bool clocked = blockIdx.x == 0 && blockIdx.y == 0 &&              \
                       blockIdx.z == 0 && threadIdx.x == 0;               \
  if (clocked) {                                                          \
    for (int q = 0; q < 6; ++q) clk_sum[q] = 0;                           \
    clk_sum[5] = clock64();                                               \
  }                                                                       \
  unsigned long long clk_last = clocked ? clk_sum[5] : 0
#define XOR_CLOCK(k)                                                      \
  do {                                                                    \
    if (clocked) {                                                        \
      const unsigned long long now = clock64();                           \
      clk_sum[k] += now - clk_last;                                       \
      clk_last = now;                                                     \
    }                                                                     \
  } while (0)
#define XOR_CLOCK_DONE()                                                  \
  do {                                                                    \
    if (clocked) {                                                        \
      clk_sum[5] = clock64() - clk_sum[5];                                \
      for (int q = 0; q < 6; ++q) xor_clocks[q] = clk_sum[q];             \
    }                                                                     \
  } while (0)
extern "C" int xor_clocks_read(void* host) {
  return static_cast<int>(
      cudaMemcpyFromSymbol(host, xor_clocks, sizeof(xor_clocks)));
}
#else
#define XOR_CLOCK_INIT() \
  do {                   \
  } while (0)
#define XOR_CLOCK(k) \
  do {               \
  } while (0)
#define XOR_CLOCK_DONE() \
  do {                   \
  } while (0)
#endif

template <int L, bool kIdx, Fill kFill, bool kHintMajor>
__global__ void __launch_bounds__(kStThreads, 1)
    staged_kernel(const __grid_constant__ StagedArgs a) {
  constexpr int kSlot = kStThreads / L;        // hints per slot
  constexpr int kSlots = kStSlots;
  constexpr int kHints = kSlots * kSlot;       // hints per CTA
  static_assert(kStThreads % L == 0, "a thread owns one piece of a row");
  extern __shared__ __align__(128) uint4 smem[];
  XOR_CLOCK_INIT();
  const int tid = threadIdx.x;
  const int c = kHintMajor ? blockIdx.y : blockIdx.x;
  const int b0 = (kHintMajor ? blockIdx.x : blockIdx.y) * a.hb;
  const int p = blockIdx.z;
  const int S = a.S, C = a.C;
  const int nb = min(a.hb, a.B - b0);
  if (nb <= 0) return;
  const int piece = tid % L, own = tid / L;
  const size_t s_stride = static_cast<size_t>(a.P) * a.part;
  // the slice's row 0 of chunk 0, and the thread's piece of it
  const uint4* slice0 = a.db + p * a.part + (c / a.spp) * a.plane +
                        (c % a.spp) * a.slice;
  const uint4* src0 = slice0 + piece;
  // uint16 row indices a stage (kIdx): hb rounded up to a slot;
  // the block's own (all but the last block: hb) are copied each chunk
  const int idx_pad = kIdx ? (a.hb + kSlot - 1) / kSlot * kSlot : 0;
  const int idx_own = kIdx ? min(a.hb, a.Bp - b0) : 0;
  // a stage (uint4): its rows, then its indices, to a multiple of 128 B
  const int rows_l = a.stage_rows * L;
  const int stage = (rows_l + idx_pad / 8 + 7) / 8 * 8;
  uint4* ring = smem;
  int32_t* raw = reinterpret_cast<int32_t*>(smem + kStStages * stage);
  uint32_t* runs = reinterpret_cast<uint32_t*>(raw + kHints * kStRun);
  // the stages' mbarriers, after the offset runs (or the stages)
  uint64_t* full = reinterpret_cast<uint64_t*>(
      kIdx ? static_cast<void*>(raw)
           : static_cast<void*>(runs + kStRun / 2 * kHints));
  const int32_t* off0 = a.offsets + (static_cast<size_t>(p) * a.B + b0) * S;
  const uint32_t C32 = static_cast<uint32_t>(C);

  // row C of every stage is zero, and every index the copies do not write
  // names it
  for (int z = tid; z < kStStages * L; z += kStThreads) {
    ring[(z / L) * stage + C * L + z % L] = make_uint4(0u, 0u, 0u, 0u);
  }
  if constexpr (kIdx) {
    const int tail = idx_pad - idx_own;
    for (int z = tid; z < kStStages * tail; z += kStThreads) {
      reinterpret_cast<uint16_t*>(ring + (z / tail) * stage +
                                  rows_l)[idx_own + z % tail] =
          static_cast<uint16_t>(C);
    }
  }
  if constexpr (kFill != kCpAsync) {
    if (tid == 0) {
      for (int st = 0; st < kStStages; ++st) mbar_init(full + st, 1);
    }
    __syncthreads();
  }
  // chunk s's slice into its stage (and, with kIdx, the block's row
  // indices of chunk s)
  auto issue = [&](int s) {
    uint4* dst = ring + (s % kStStages) * stage;
    const uint16_t* isrc =
        a.idx + (static_cast<size_t>(p) * S + s) * a.Bp + b0;
    if constexpr (kFill != kCpAsync) {
      if (tid == 0) {
        const int R = a.box_rows, boxes = (C + R - 1) / R;
        const uint32_t rows = static_cast<uint32_t>(
            kFill == kBulk ? C : boxes * R) * L * 16;
        const uint32_t ix = static_cast<uint32_t>(idx_own) * 2;
        uint64_t* bar = full + s % kStStages;
        mbar_arrive_expect(bar, rows + ix);
        if constexpr (kFill == kBulk) {
          bulk_copy(dst, slice0 + s * s_stride, rows, bar);
        } else {
          // slice c is bytes (c % spp) * L * 16 .. of plane c / spp
          const int x = (c % a.spp) * L * 16;
          const int z = (s * a.P + p) * a.planes + c / a.spp;
          for (int j = 0; j < boxes; ++j) {
            tma_load_3d(dst + j * R * L, &a.map, x, j * R, z, bar);
          }
        }
        if (ix) bulk_copy(dst + rows_l, isrc, ix, bar);
      }
    } else {
      const uint4* src = src0 + s * s_stride;
      for (int r = own, n = tid; r < C; r += kSlot, n += kStThreads) {
        cp_async16(dst + n, src + r * a.row, 16);
      }
      if constexpr (kIdx) {
        // idx_own is a multiple of 8: 16-byte pieces
        for (int j = tid; j < idx_own / 8; j += kStThreads) {
          cp_async16(dst + rows_l + j, isrc + 8 * j, 16);
        }
      }
    }
  };
  // offsets of chunks s0 .. s0 + kStRun - 1 of the block's hints into raw
  // (entries past S or nb are left as they fall: the packing masks them)
  auto issue_run = [&](int s0) {
    for (int e = tid; e < kHints * kStRun / 4; e += kStThreads) {
      const int h = e / (kStRun / 4), q = 4 * (e % (kStRun / 4));
      const int32_t* src = off0 + static_cast<size_t>(h) * S + s0 + q;
      int32_t* dst = raw + h * kStRun + q;
      if (a.vec_off) {
        const bool ok = h < nb && s0 + q < S;
        cp_async16(dst, ok ? src : a.offsets, ok ? 16 : 0);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool ok = h < nb && s0 + q + j < S;
          cp_async4(dst + j, ok ? src + j : a.offsets, ok ? 4 : 0);
        }
      }
    }
  };
  if constexpr (!kIdx) issue_run(0);
  for (int s = 0; s < kStStages - 1; ++s) {
    if (s < S) issue(s);
    cp_async_commit();
  }

  uint4 acc[kSlots];
#pragma unroll
  for (int i = 0; i < kSlots; ++i) acc[i] = make_uint4(0u, 0u, 0u, 0u);
  XOR_CLOCK(2);
  for (int s0 = 0; s0 < S; s0 += kStRun) {
#pragma unroll
    for (int u = 0; u < kStRun; ++u) {
      const int s = s0 + u;
      if (s >= S) break;
      // chunk s has landed (for this thread; after the barrier, for every
      // thread), and chunk s - 1 is done with
      if constexpr (kFill != kCpAsync) {
        mbar_wait(full + s % kStStages, (s / kStStages) & 1);
      }
      cp_async_wait<kStStages - 2>();
      __syncthreads();
      XOR_CLOCK(0);
      if constexpr (!kIdx) {
        if (u == 0) {
          // the run's row indices, two to a word, C for a skip (or a chunk
          // past S, or a hint past nb); then the next run's offsets
          for (int h = tid; h < kHints; h += kStThreads) {
            const int32_t* o = raw + h * kStRun;
#pragma unroll
            for (int q = 0; q < kStRun / 2; ++q) {
              uint32_t lo = static_cast<uint32_t>(o[2 * q]);
              uint32_t hi = static_cast<uint32_t>(o[2 * q + 1]);
              lo = (h < nb && s0 + 2 * q < S && lo < C32) ? lo : C32;
              hi = (h < nb && s0 + 2 * q + 1 < S && hi < C32) ? hi : C32;
              runs[q * kHints + h] = lo | (hi << 16);
            }
          }
          __syncthreads();
          if (s0 + kStRun < S) issue_run(s0 + kStRun);
          XOR_CLOCK(1);
        }
      }
      if (s + kStStages - 1 < S) issue(s + kStStages - 1);
      cp_async_commit();
      XOR_CLOCK(2);
      const uint4* rows = ring + (s % kStStages) * stage + piece;
      if constexpr (!kIdx) {
        const uint32_t* pair = runs + (u / 2) * kHints + own;
#pragma unroll
        for (int i = 0; i < kSlots; ++i) {
          if (i * kSlot < nb) {
            const uint32_t r = (pair[i * kSlot] >> ((u & 1) * 16)) & 0xFFFFu;
            xor_into(acc[i], rows[r * L]);
          }
        }
      } else {
        const uint16_t* sidx = reinterpret_cast<const uint16_t*>(
                                   rows - piece + rows_l) + own;
#pragma unroll
        for (int i = 0; i < kSlots; ++i) {
          if (i * kSlot < nb) xor_into(acc[i], rows[sidx[i * kSlot] * L]);
        }
      }
      XOR_CLOCK(3);
    }
  }
  const size_t e4 = static_cast<size_t>(a.k) * 32;   // uint4 per output row
  uint4* out = a.out + (static_cast<size_t>(p) * a.B + b0) * e4 + c * L + piece;
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    const int h = i * kSlot + own;
    if (h < nb) out[h * e4] = acc[i];
  }
  XOR_CLOCK(4);
  XOR_CLOCK_DONE();
}

// planes 0-3 (a.x .. a.w) of 4 words -> the 4 words: word j takes byte j
// of each plane, plane b as its byte b
__device__ __forceinline__ uint4 assemble_planes(const uint4 a) {
  const uint32_t lo01 = __byte_perm(a.x, a.y, 0x5140);
  const uint32_t hi01 = __byte_perm(a.x, a.y, 0x7362);
  const uint32_t lo23 = __byte_perm(a.z, a.w, 0x5140);
  const uint32_t hi23 = __byte_perm(a.z, a.w, 0x7362);
  return make_uint4(__byte_perm(lo01, lo23, 0x5410),
                    __byte_perm(lo01, lo23, 0x7632),
                    __byte_perm(hi01, hi23, 0x5410),
                    __byte_perm(hi01, hi23, 0x7632));
}

// K7a's words: planes (rows, 4, E / 4) u32, each row's 4 planes of E bytes
// (byte w of plane b is byte b of word w) -> out (rows, E / 4) uint4. A
// thread assembles 4 words from one u32 of each plane.
__global__ void __launch_bounds__(256) plane_words_kernel(
    const uint32_t* __restrict__ planes, uint4* __restrict__ out,
    long long rows, int E) {
  const long long q = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  const int per_row = E / 4;   // u32 of a plane row, uint4 of an out row
  if (q >= rows * per_row) return;
  const long long row = q / per_row;
  const int w = static_cast<int>(q - row * per_row);
  const uint32_t* src = planes + row * E + w;
  out[q] = assemble_planes(make_uint4(__ldg(src), __ldg(src + per_row),
                                      __ldg(src + 2 * per_row),
                                      __ldg(src + 3 * per_row)));
}

// K7b's and K7c's row indices: offsets and skip (P, B, S) -> idx (P, S,
// Bp) uint16, the offset where it is in [0, C) and not skipped, else C,
// the zero row (Bp = B rounded up to 8, the pad C), through a 32 x 32
// tile in shared memory so that both the reads and the writes are
// coalesced; the grid's z is the partition.
__global__ void __launch_bounds__(256) index_kernel(
    const int32_t* __restrict__ offsets, const uint8_t* __restrict__ skip,
    uint16_t* __restrict__ idx, int B, int S, int C, int Bp) {
  __shared__ uint16_t tile[32][34];
  const int b0 = blockIdx.x * 32, s0 = blockIdx.y * 32;
  const size_t part = static_cast<size_t>(blockIdx.z) * B * S;
  offsets += part;
  skip += part;
  idx += static_cast<size_t>(blockIdx.z) * S * Bp;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  for (int j = ty; j < 32; j += 8) {
    const int b = b0 + j, s = s0 + tx;
    uint16_t v = static_cast<uint16_t>(C);
    if (b < B && s < S) {
      const size_t at = static_cast<size_t>(b) * S + s;
      const uint32_t o = static_cast<uint32_t>(__ldg(offsets + at));
      if (!__ldg(skip + at) && o < static_cast<uint32_t>(C)) {
        v = static_cast<uint16_t>(o);
      }
    }
    tile[j][tx] = v;
  }
  __syncthreads();
  for (int j = ty; j < 32; j += 8) {
    const int s = s0 + j, b = b0 + tx;
    if (s < S && b < Bp) idx[static_cast<size_t>(s) * Bp + b] = tile[tx][j];
  }
}

// K7c's slice-major copy: src (S, C, W) uint4 -> dst (S, W / L, C, L)
// uint4, slice c of row r holding the row's uint4 c*L .. c*L + L - 1. A
// block moves R rows through shared memory: the reads are whole rows, the
// writes R*L uint4 of each slice, both coalesced; the tile's rows are
// padded by 2 uint4, so that a quarter-warp's reads (4 rows' slices) hit
// distinct banks.
template <int L>
__global__ void __launch_bounds__(256) slice_major_kernel(
    const uint4* __restrict__ src, uint4* __restrict__ dst, int C, int W,
    int R) {
  extern __shared__ uint4 tile[];   // R x (W + 2)
  const int r0 = blockIdx.x * R, rows = min(R, C - r0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t chunk = static_cast<size_t>(blockIdx.y) * C * W;
  for (int r = warp; r < rows; r += 8) {
    const uint4* row = src + chunk + static_cast<size_t>(r0 + r) * W;
    for (int u = lane; u < W; u += 32) tile[r * (W + 2) + u] = row[u];
  }
  __syncthreads();
  uint4* out = dst + chunk + static_cast<size_t>(r0) * L;
  for (int c = warp; c < W / L; c += 8) {
    for (int e = lane; e < rows * L; e += 32) {
      out[static_cast<size_t>(c) * C * L + e] =
          tile[(e / L) * (W + 2) + c * L + e % L];
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
  // acc[r] holds planes 0-3 of the lane's words 4l..4l+3
#pragma unroll
  for (int r = 0; r < G; ++r) dst[r * 32] = assemble_planes(acc[r]);
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

// K2, all three forms: db (S, P, C*k, 128) int32; offsets (P, B, S) int32;
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

// The sliced form: 4k column slices of 128 bytes, B in balanced hint
// blocks of at most kSlBlock; the grid (hint block, partition, slice), so
// that the CTAs launched together share a slice and a partition.
extern "C" int xor_gather_sliced(const void* db, const void* offsets,
                                 void* out, int S, int P, int C, int k,
                                 int B, void* stream) {
  if (k < 1 || C < 1 || S < 0 || P < 0 || B < 0 || P > 65535 ||
      k > 65535 / 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (P == 0 || B == 0) return 0;
  const int blocks = (B + kSlBlock - 1) / kSlBlock;
  const int hb = (B + blocks - 1) / blocks;   // balanced hint blocks
  sliced_row_split_kernel<<<dim3(blocks, P, 4 * k), kSlThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(db), static_cast<const int32_t*>(offsets),
      static_cast<uint4*>(out), S, P, C, B, k, hb);
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory of a staged launch: the ring (stage_rows rows of L
// uint4 a stage, then with kIdx the row indices, hb rounded up to a slot,
// to a multiple of 128 bytes), then without kIdx the run's offsets and
// the packed run, then with bulk or tensor fills the stages' mbarriers.
template <int L, bool kIdx, Fill kFill>
static size_t staged_smem(int stage_rows, int hb) {
  constexpr int kSlot = kStThreads / L;
  constexpr size_t kHints = static_cast<size_t>(kStSlots) * kSlot;
  const size_t idx_pad = kIdx ? (hb + kSlot - 1) / kSlot * kSlot : 0;
  const size_t stage =
      (static_cast<size_t>(stage_rows) * L * sizeof(uint4) + idx_pad * 2 +
       127) / 128 * 128;
  return kStStages * stage +
         (kIdx ? 0
               : kHints * kStRun * sizeof(int32_t) +
                     kStRun / 2 * kHints * sizeof(uint32_t)) +
         (kFill != kCpAsync ? kStStages * sizeof(uint64_t) : 0);
}

// cuTensorMapEncodeTiled from libcuda, looked up through the runtime's
// entry-point query, so that the library links the runtime alone.
using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// a.map over `planes_total` planes of C rows of row_bytes bytes from base,
// boxes of box_bytes x a.box_rows x 1 bytes; a.box_rows = min(C, 256), and
// a stage holds the boxes' rows (at least C + 1: row C is zero).
static int tensor_map(StagedArgs& a, const void* base, size_t row_bytes,
                      size_t planes_total, int box_bytes) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t rc = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) {
      return static_cast<int>(cudaErrorNotSupported);
    }
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  a.box_rows = a.C < 256 ? a.C : 256;
  const int boxes = (a.C + a.box_rows - 1) / a.box_rows;
  a.stage_rows = boxes * a.box_rows > a.C ? boxes * a.box_rows : a.C + 1;
  const cuuint64_t dims[3] = {row_bytes, static_cast<cuuint64_t>(a.C),
                              planes_total};
  const cuuint64_t strides[2] = {row_bytes, row_bytes * a.C};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_bytes),
                             static_cast<cuuint32_t>(a.box_rows), 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult r = encode(
      &a.map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(base), dims,
      strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// Launches staged_kernel<L, kIdx, kFill, kHintMajor> over a (P, B) output
// of k-row entries in `slices` column slices, B in balanced hint blocks of
// at most kHints (rounded up to 8 with kIdx, for the 16-byte index
// copies).
// Refuses (cudaErrorInvalidValue) C >= 65,535 (16-bit row indices) and a
// ring larger than the device's opt-in shared memory.
template <int L, bool kIdx, Fill kFill, bool kHintMajor = false>
static int launch_staged(StagedArgs& a, int slices, void* stream) {
  constexpr int kHints = kStSlots * (kStThreads / L);
  if (a.k < 1 || a.C < 1 || a.C >= 0xFFFF || a.S < 0 || a.P < 0 ||
      a.B < 0 || a.P > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (a.P == 0 || a.B == 0) return 0;
  if (kFill != kTensor) a.stage_rows = a.C + 1;
  const int blocks = (a.B + kHints - 1) / kHints;
  a.hb = (a.B + blocks - 1) / blocks;   // balanced hint blocks
  if (kIdx) a.hb = (a.hb + 7) / 8 * 8;
  if (blocks > 65535 || slices > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = staged_smem<L, kIdx, kFill>(a.stage_rows, a.hb);
  int dev = 0, limit = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess) {
    rc = cudaDeviceGetAttribute(
        &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (smem > static_cast<size_t>(limit)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = staged_kernel<L, kIdx, kFill, kHintMajor>;
  static size_t opted = 48 * 1024;   // the size every kernel may use unasked
  if (smem > opted) {
    rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
    opted = smem;
  }
  const dim3 grid = kHintMajor ? dim3(blocks, slices, a.P)
                               : dim3(slices, blocks, a.P);
  kernel<<<grid, kStThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// K2's chunk form and K7b's staged form read 64-byte column slices of the
// (S, P, C*k, 128) DB.
static StagedArgs chunk_args(const void* db, void* out, int S, int P,
                             int C, int k, int B) {
  StagedArgs a{};
  a.db = static_cast<const uint4*>(db);
  a.row = static_cast<size_t>(k) * 32;
  a.slice = 4;
  a.part = static_cast<size_t>(C) * k * 32;
  a.spp = 8 * k;
  a.out = static_cast<uint4*>(out);
  a.S = S, a.P = P, a.C = C, a.B = B, a.k = k;
  return a;
}

// Launches index_kernel over P partitions of (B, S) offsets and skip.
static int launch_index(const void* offsets, const void* skip, uint16_t* idx,
                        int P, int B, int S, int C, int Bp,
                        cudaStream_t st) {
  const dim3 grid((Bp + 31) / 32, (S + 31) / 32, P);
  if (grid.y > 65535 || grid.z > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  index_kernel<<<grid, 256, 0, st>>>(static_cast<const int32_t*>(offsets),
                                     static_cast<const uint8_t*>(skip), idx,
                                     B, S, C, Bp);
  return static_cast<int>(cudaGetLastError());
}

// The chunk-major form: staged_kernel with 64-byte rows (4 lanes a hint,
// 2,560 hints a CTA). Refuses C >= 65,535 and a ring larger than the
// device's opt-in shared memory (C above 855 on an H100).
extern "C" int xor_gather_chunk_major(const void* db, const void* offsets,
                                      void* out, int S, int P, int C, int k,
                                      int B, void* stream) {
  StagedArgs a = chunk_args(db, out, S, P, C, k, B);
  a.offsets = static_cast<const int32_t*>(offsets);
  a.vec_off = S % 4 == 0 && reinterpret_cast<uintptr_t>(offsets) % 16 == 0;
  return launch_staged<4, false, kCpAsync>(a, 8 * k, stream);
}

// K7b. db (S, P, C*k, 128) int32; offsets (P, B, S) int32, skip (P, B, S)
// bool; out (P, B, k, 128). staged = 0: the warp-per-row form (scratch
// unused); else index_kernel writes the (P, S, Bp) uint16 row indices into
// scratch (P*S*Bp*2 bytes, Bp = B rounded up to 8) and staged_kernel runs
// in K2's chunk geometry on them, refusing C >= 65,535 and a ring larger
// than the device's opt-in shared memory (C above 1,735 on an H100).
extern "C" int xor_hintgen_skip(const void* db, const void* offsets,
                                const void* skip, void* scratch, void* out,
                                int S, int P, int C, int k, int B,
                                int staged, void* stream) {
  if (!staged) {
    return launch<GatherLaunch<true>>(db, offsets, skip, out, S, P, C, k, B,
                                      stream);
  }
  if (k < 1 || C < 1 || C >= 0xFFFF || S < 0 || P < 0 || B < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (P == 0 || B == 0) return 0;
  const int Bp = (B + 7) / 8 * 8;
  uint16_t* idx = static_cast<uint16_t*>(scratch);
  if (S > 0) {
    const int rc = launch_index(offsets, skip, idx, P, B, S, C, Bp,
                                static_cast<cudaStream_t>(stream));
    if (rc != 0) return rc;
  }
  StagedArgs a = chunk_args(db, out, S, P, C, k, B);
  a.idx = idx;
  a.Bp = Bp;
  return launch_staged<4, true, kCpAsync>(a, 8 * k, stream);
}

// K7c. db (S, C*k, 128) int32; offsets and skip (B, S); out (B, k, 128):
// the flat layout is K7b's at P = 1. staged = 0: the warp-per-row form
// (scratch unused); else the staged form, 32-byte rows (2 lanes a hint,
// 5,120 hints a CTA, each stage one bulk copy, the grid hint-block-major),
// read from a slice-major copy of db (slice_major_kernel) at the start of
// scratch, followed by the (S, Bp) uint16 row indices index_kernel
// writes (Bp = B rounded up to 8): S*C*k*512 + S*Bp*2 bytes. The staged
// form refuses C >= 65,535 and a ring larger than the device's opt-in
// shared memory (C above 3,310 on an H100).
extern "C" int xor_scan_flat(const void* db, const void* offsets,
                             const void* skip, void* scratch, void* out,
                             int S, int C, int k, int B, int staged,
                             void* stream) {
  if (!staged) {
    return launch<GatherLaunch<true>>(db, offsets, skip, out, S, 1, C, k, B,
                                      stream);
  }
  if (k < 1 || C < 1 || C >= 0xFFFF || S < 0 || B < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int Bp = (B + 7) / 8 * 8;
  const int W = 32 * k;   // uint4 per entry
  uint4* sliced = static_cast<uint4*>(scratch);
  uint16_t* idx =
      reinterpret_cast<uint16_t*>(sliced + static_cast<size_t>(S) * C * W);
  if (S > 0) {
    // R = 32 rows a block, halved while the tile exceeds 48 KiB
    int R = 32;
    while (R > 1 && R * (W + 2) * 16 > 48 * 1024) R /= 2;
    if ((W + 2) * 16 > 48 * 1024 || S > 65535) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    slice_major_kernel<2><<<dim3((C + R - 1) / R, S), 256,
                            R * (W + 2) * 16, st>>>(
        static_cast<const uint4*>(db), sliced, C, W, R);
    int rc = static_cast<int>(cudaGetLastError());
    if (rc != 0) return rc;
    rc = launch_index(offsets, skip, idx, 1, B, S, C, Bp, st);
    if (rc != 0) return rc;
  }
  StagedArgs a{};
  a.db = sliced;
  a.slice = static_cast<size_t>(C) * 2;
  a.part = static_cast<size_t>(C) * W;
  a.spp = W / 2;
  a.idx = idx;
  a.out = static_cast<uint4*>(out);
  a.S = S, a.P = 1, a.C = C, a.B = B, a.k = k, a.Bp = Bp;
  return launch_staged<2, true, kBulk, true>(a, W / 2, stream);
}

// K7a. dbp (S, P, 4, C, k*128) int8; offsets (P, B, S) int32 with skips as
// any offset outside [0, C); out (P, B, k*128) int32. staged = 0: the
// warp-per-row form (scratch unused); else the staged form on 128-byte
// rows of one plane (8 lanes a hint, 1,280 hints a CTA, 4k slices: plane
// c / k, bytes 128 (c % k) .., each stage filled by TMA boxes of a tensor
// map over dbp), whose output, each row's 4 planes of
// k*128 bytes, goes to scratch (P*B*k*512 bytes) for plane_words_kernel to
// assemble into out. The staged form refuses C >= 65,535 and a ring larger
// than the device's opt-in shared memory (C above 667 on an H100).
extern "C" int xor_hintgen_planes(const void* dbp, const void* offsets,
                                  void* scratch, void* out, int S, int P,
                                  int C, int k, int B, int staged,
                                  void* stream) {
  if (!staged) {
    return launch<PlaneLaunch>(dbp, offsets, nullptr, out, S, P, C, k, B,
                               stream);
  }
  if (C < 1 || C >= 0xFFFF || k < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  StagedArgs a{};
  a.C = C;
  if (S > 0 && P > 0) {
    const int rc = tensor_map(a, dbp, static_cast<size_t>(k) * 128,
                              static_cast<size_t>(S) * P * 4, 128);
    if (rc != 0) return rc;
  }
  a.planes = 4;
  a.spp = k;
  a.offsets = static_cast<const int32_t*>(offsets);
  a.out = static_cast<uint4*>(scratch);
  a.S = S, a.P = P, a.C = C, a.B = B, a.k = k;
  a.vec_off = S % 4 == 0 && reinterpret_cast<uintptr_t>(offsets) % 16 == 0;
  int rc = launch_staged<8, false, kTensor>(a, 4 * k, stream);
  if (rc != 0 || P == 0 || B == 0) return rc;
  const long long words = static_cast<long long>(P) * B * k * 32;
  plane_words_kernel<<<static_cast<unsigned int>((words + 255) / 256), 256,
                       0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(scratch), static_cast<uint4*>(out),
      static_cast<long long>(P) * B, k * 128);
  return static_cast<int>(cudaGetLastError());
}
