// K1 and K5: AES-128-MMO PRF evaluations with per-partition keys, sm_90a.
//
// PRF_key(t, x) = low32(AES-128-MMO_key(LE64((t << 35) + x) || 0^8)): the
// input block is the words (x, t << 3, 0, 0) (pianopir/util.go:157-165) and
// MMO is E_k(m) ^ m, so the low word is the cipher's word 0 ^ x. Two entry
// points, one block setup and one round function (MmoBlock):
//   K1 aes_mmo_tables replaces the Pallas kernel `_aes_mmo_kernel`
//      (pacmann_tpu/ops/aes_pallas.py, via prf_tables_pallas): the offset
//      tables out[p, t, s] = PRF_{key_p}(t, s) & chunk_mask on the hint-table
//      lattice t < T, s < S;
//   K5 aes_mmo_points replaces `_aes_mmo_kernel_perp` (via
//      prf_eval_fused_pallas): the table-free client's online PRF,
//      out[p, l] = PRF_{key_p}(tags[p, l], xs[p, l]) & chunk_mask.
//
// The TPU kernels evaluate a bitsliced circuit (with the plane packing that
// feeds it) because the TPU has no byte lookups. Hopper does, so both are
// T-table AES: one thread per evaluation, blockIdx.y selecting the partition.
//
// Bound on the H100: shared-memory lookups and integer work, 140 lookups per
// evaluation (16 per round for rounds 1-9 less round 1's eight constant
// ones, 4 S-box reads for word 0 of the last round; only the low output
// word is needed). K1 writes 4 bytes per evaluation and K5 reads 8 more, so
// device memory is not the limit.
//
// The design: lookups without bank conflicts. For every byte x the block
// holds 32 copies of Te0[x] and 32 of Te2[x], at byte address x * 256 +
// table * 128 + lane * 4 (64 KB, two CTAs of 512 threads an SM). Lane l
// reads only its own copies, which lie in bank l whatever byte it looks up:
// one wavefront per warp-wide lookup, where random bytes into one 256-word
// table take 3-4. The address is one byte permute (PRMT) of the state word
// and the lane's offset. Te1 and Te3 are Te0 and Te2 rotated by 8 bits, so a
// column is Te0[a] ^ Te2[c] ^ rot8(Te0[b] ^ Te2[d] ^ rotr8(key)): 4 PRMT, 4
// LDS and 3 logic operations. The last round's S-box byte is a byte of
// Te0[x] or Te2[x], so there is no other table. The round keys sit in
// registers; round 1's eight lookups on words 2 and 3 of the block (0 before
// whitening) are the same for the whole partition and are folded into its
// round key once per block. Per evaluation: 140 lookups against about 260
// integer operations, so the lookups (32 words a clock an SM) stay the
// limit, ahead of integer issue (64 a clock).
//
// Each block builds the 64 KB image itself: thread t computes one (byte,
// table) word and stores its 32 copies as eight 16-byte stores, rotated by
// t so that each 8 neighbouring threads' stores hit 8 distinct groups of 4
// banks (the image's 512 wavefronts, no more). The grid: K1 takes one wave
// of resident blocks shared by the partitions (ceil(wave / P) a partition),
// each striding over its partition's lattice; K5, whose lists are short
// (P = 16, 1,488 to 23,808 points a partition on the online path), takes
// blocks sized to its points: fewer points than one block of 512 an SM are
// spread one block an SM (at Q = 6, 8 blocks of 192 threads a partition),
// more take blocks of 512, at most a whole wave in all (floor(wave / P) a
// partition), so that no block waits for a second wave.
//
// Words are little-endian: state byte j = row (j % 4) of column (j / 4) is
// bits 8*(j%4) of word j/4, as the FIPS-197 byte order maps onto u32 loads.

#include <cstdint>
#include <cuda_runtime.h>

__constant__ uint8_t kSbox[256] = {
    0x63, 0x7c, 0x77, 0x7b, 0xf2, 0x6b, 0x6f, 0xc5, 0x30, 0x01, 0x67, 0x2b, 0xfe, 0xd7, 0xab, 0x76,
    0xca, 0x82, 0xc9, 0x7d, 0xfa, 0x59, 0x47, 0xf0, 0xad, 0xd4, 0xa2, 0xaf, 0x9c, 0xa4, 0x72, 0xc0,
    0xb7, 0xfd, 0x93, 0x26, 0x36, 0x3f, 0xf7, 0xcc, 0x34, 0xa5, 0xe5, 0xf1, 0x71, 0xd8, 0x31, 0x15,
    0x04, 0xc7, 0x23, 0xc3, 0x18, 0x96, 0x05, 0x9a, 0x07, 0x12, 0x80, 0xe2, 0xeb, 0x27, 0xb2, 0x75,
    0x09, 0x83, 0x2c, 0x1a, 0x1b, 0x6e, 0x5a, 0xa0, 0x52, 0x3b, 0xd6, 0xb3, 0x29, 0xe3, 0x2f, 0x84,
    0x53, 0xd1, 0x00, 0xed, 0x20, 0xfc, 0xb1, 0x5b, 0x6a, 0xcb, 0xbe, 0x39, 0x4a, 0x4c, 0x58, 0xcf,
    0xd0, 0xef, 0xaa, 0xfb, 0x43, 0x4d, 0x33, 0x85, 0x45, 0xf9, 0x02, 0x7f, 0x50, 0x3c, 0x9f, 0xa8,
    0x51, 0xa3, 0x40, 0x8f, 0x92, 0x9d, 0x38, 0xf5, 0xbc, 0xb6, 0xda, 0x21, 0x10, 0xff, 0xf3, 0xd2,
    0xcd, 0x0c, 0x13, 0xec, 0x5f, 0x97, 0x44, 0x17, 0xc4, 0xa7, 0x7e, 0x3d, 0x64, 0x5d, 0x19, 0x73,
    0x60, 0x81, 0x4f, 0xdc, 0x22, 0x2a, 0x90, 0x88, 0x46, 0xee, 0xb8, 0x14, 0xde, 0x5e, 0x0b, 0xdb,
    0xe0, 0x32, 0x3a, 0x0a, 0x49, 0x06, 0x24, 0x5c, 0xc2, 0xd3, 0xac, 0x62, 0x91, 0x95, 0xe4, 0x79,
    0xe7, 0xc8, 0x37, 0x6d, 0x8d, 0xd5, 0x4e, 0xa9, 0x6c, 0x56, 0xf4, 0xea, 0x65, 0x7a, 0xae, 0x08,
    0xba, 0x78, 0x25, 0x2e, 0x1c, 0xa6, 0xb4, 0xc6, 0xe8, 0xdd, 0x74, 0x1f, 0x4b, 0xbd, 0x8b, 0x8a,
    0x70, 0x3e, 0xb5, 0x66, 0x48, 0x03, 0xf6, 0x0e, 0x61, 0x35, 0x57, 0xb9, 0x86, 0xc1, 0x1d, 0x9e,
    0xe1, 0xf8, 0x98, 0x11, 0x69, 0xd9, 0x8e, 0x94, 0x9b, 0x1e, 0x87, 0xe9, 0xce, 0x55, 0x28, 0xdf,
    0x8c, 0xa1, 0x89, 0x0d, 0xbf, 0xe6, 0x42, 0x68, 0x41, 0x99, 0x2d, 0x0f, 0xb0, 0x54, 0xbb, 0x16,
};

constexpr int kThreads = 512;
constexpr int kTablesBytes = 256 * 256;
constexpr uint32_t kTe2 = 128;   // byte offset of the Te2 copies in a row

__device__ __forceinline__ uint32_t xtime(uint32_t b) {
  return ((b << 1) ^ ((b & 0x80u) ? 0x1bu : 0u)) & 0xffu;
}

// byte address of Te[byte k of w] in the copy at `lane_off` (< 256):
// (byte << 8) | lane_off
template <int k>
__device__ __forceinline__ uint32_t entry(uint32_t w, uint32_t lane_off) {
  return __byte_perm(w, lane_off, 0x5504 | (k << 4));
}

__device__ __forceinline__ uint32_t load(const uint8_t* tab, uint32_t at) {
  return *reinterpret_cast<const uint32_t*>(tab + at);
}

// Te_k[x] = Te0[x] rotated left by 8k bits
__device__ __forceinline__ uint32_t rot(uint32_t w, int k) {
  return __funnelshift_l(w, w, 8 * k);
}

// one output column of rounds 2-9 from the input words a, b, c, d (bytes 0,
// 1, 2, 3): Te0[a] ^ Te2[c] ^ rot8(Te0[b] ^ Te2[d] ^ kr), where kr is the
// round-key word rotated right by 8, since Te1 = rot8(Te0), Te3 = rot8(Te2)
__device__ __forceinline__ uint32_t column(const uint8_t* tab, uint32_t o0,
                                           uint32_t o2, uint32_t a, uint32_t b,
                                           uint32_t c, uint32_t d,
                                           uint32_t kr) {
  const uint32_t inner = load(tab, entry<1>(b, o0)) ^
                         load(tab, entry<3>(d, o2)) ^ kr;
  return load(tab, entry<0>(a, o0)) ^ load(tab, entry<2>(c, o2)) ^
         rot(inner, 1);
}

#ifdef AES_FILL_CLOCKS
// Built only to time K5's block setup (scripts/kernel_ab.py --phases): the
// SM clock of block (0, 0) at its start (0), after the image and the round
// keys (1), after round 1's fold (2) and at its end (3), the latest of its
// warps. Marks 1 and 2 lie in the setup that K1 shares: time one kernel a
// build.
__device__ unsigned long long aes_clocks[4];
#define AES_MARK(k)                                                        \
  do {                                                                     \
    if (blockIdx.x == 0 && blockIdx.y == 0 && (threadIdx.x & 31) == 0) {   \
      atomicMax(&aes_clocks[k], static_cast<unsigned long long>(clock64())); \
    }                                                                      \
  } while (0)
extern "C" int aes_clocks_zero() {
  static const unsigned long long zero[4] = {};
  return static_cast<int>(cudaMemcpyToSymbol(aes_clocks, zero, sizeof(zero)));
}
extern "C" int aes_clocks_read(void* host) {
  return static_cast<int>(
      cudaMemcpyFromSymbol(host, aes_clocks, sizeof(aes_clocks)));
}
#else
#define AES_MARK(k) \
  do {              \
  } while (0)
#endif

// One block's view of the PRF under its partition's key: the 64 KB image in
// shared memory, the lane's copy offsets, and the round keys in registers.
struct MmoBlock {
  const uint8_t* tab;
  uint32_t o0, o2;            // this lane's Te0 and Te2 copies in a row
  uint32_t rk0, rk1, rk40;
  uint32_t kr[36];            // round keys 1-9 rotated right by 8

  // Builds the image in `te` (kTablesBytes) and the round keys of `rk_p`
  // (44 little-endian words); ends past a barrier.
  __device__ __forceinline__ void setup(uint32_t* te, const uint32_t* rk_p) {
    // thread t: the word of byte t / 2 in table t % 2 (Te0, or Te2 = Te0
    // rotated by 16), and its 32 copies
    for (uint32_t t = threadIdx.x; t < 512; t += blockDim.x) {
      const uint32_t s = kSbox[t >> 1];
      const uint32_t s2 = xtime(s);
      // column contribution of a row-0 input byte: (2s, s, s, 3s)
      uint32_t w = s2 | (s << 8) | (s << 16) | ((s2 ^ s) << 24);
      w = (t & 1) ? rot(w, 2) : w;
      uint4* row = reinterpret_cast<uint4*>(te + t * 32);
#pragma unroll
      for (uint32_t j = 0; j < 8; ++j) row[(j + t) & 7] = make_uint4(w, w, w, w);
    }
    rk0 = __ldg(rk_p);
    rk1 = __ldg(rk_p + 1);
    rk40 = __ldg(rk_p + 40);
#pragma unroll
    for (int i = 0; i < 36; ++i) kr[i] = rot(__ldg(rk_p + 4 + i), 3);
    __syncthreads();
    AES_MARK(1);
    tab = reinterpret_cast<const uint8_t*>(te);
    o0 = (threadIdx.x & 31) * 4;
    o2 = o0 | kTe2;
    // round 1 on the words 2 and 3 of the block, rk[2] and rk[3] after
    // whitening: the same for every point, folded into round key 1
    const uint32_t w2 = __ldg(rk_p + 2), w3 = __ldg(rk_p + 3);
    const uint32_t t0 = load(tab, entry<0>(w2, o0)), t1 = load(tab, entry<0>(w3, o0));
    kr[0] ^= rot(load(tab, entry<2>(w2, o2)) ^ rot(load(tab, entry<3>(w3, o2)), 1), 3);
    kr[1] ^= rot(rot(load(tab, entry<1>(w2, o0)), 1) ^ load(tab, entry<2>(w3, o2)), 3);
    kr[2] ^= rot(t0 ^ rot(load(tab, entry<1>(w3, o0)), 1), 3);
    kr[3] ^= rot(t1 ^ rot(load(tab, entry<3>(w2, o2)), 1), 3);
    AES_MARK(2);
  }

  // Low word of AES-128-MMO of the block (x, hi, 0, 0).
  __device__ __forceinline__ uint32_t low32(uint32_t x, uint32_t hi) const {
    // (x, hi, 0, 0) whitened; round 1 looks up words 0 and 1 only: column
    // c = (Te0[b0 of c] ^ Te1[b1 of c+1] ^ Te2[b2 of c+2] ^ Te3[b3 of
    // c+3]), the words-2-and-3 terms in kr[0..3]
    const uint32_t x0 = x ^ rk0, x1 = hi ^ rk1;
    uint32_t a0 = load(tab, entry<0>(x0, o0)) ^
                  rot(load(tab, entry<1>(x1, o0)) ^ kr[0], 1);
    uint32_t a1 = load(tab, entry<0>(x1, o0)) ^
                  rot(load(tab, entry<3>(x0, o2)) ^ kr[1], 1);
    uint32_t a2 = load(tab, entry<2>(x0, o2)) ^
                  rot(load(tab, entry<3>(x1, o2)) ^ kr[2], 1);
    uint32_t a3 = load(tab, entry<2>(x1, o2)) ^
                  rot(load(tab, entry<1>(x0, o0)) ^ kr[3], 1);
#pragma unroll
    for (int r = 2; r < 10; ++r) {
      // output column c takes row j from input column (c + j) % 4
      const uint32_t n0 = column(tab, o0, o2, a0, a1, a2, a3, kr[4 * r - 4]);
      const uint32_t n1 = column(tab, o0, o2, a1, a2, a3, a0, kr[4 * r - 3]);
      const uint32_t n2 = column(tab, o0, o2, a2, a3, a0, a1, kr[4 * r - 2]);
      const uint32_t n3 = column(tab, o0, o2, a3, a0, a1, a2, kr[4 * r - 1]);
      a0 = n0;
      a1 = n1;
      a2 = n2;
      a3 = n3;
    }
    // last round, column 0: S[x] is bytes 1 and 2 of Te0[x], bytes 0 and 3
    // of Te2[x]
    const uint32_t c0 = (load(tab, entry<0>(a0, o2)) & 0xffu) |
                        (load(tab, entry<1>(a1, o0)) & 0xff00u) |
                        (load(tab, entry<2>(a2, o0)) & 0xff0000u) |
                        (load(tab, entry<3>(a3, o2)) & 0xff000000u);
    return c0 ^ rk40 ^ x;  // MMO feed-forward
  }
};

__global__ void __launch_bounds__(kThreads, 2) aes_mmo_tables_kernel(
    const uint32_t* __restrict__ round_keys,  // (P, 44) little-endian words
    int32_t* __restrict__ out,                // (P, T, S)
    uint32_t n_evals,                         // T * S
    uint32_t S, uint32_t chunk_mask) {
  extern __shared__ uint32_t te[];            // kTablesBytes
  const uint32_t p = blockIdx.y;
  MmoBlock b;
  b.setup(te, round_keys + p * 44);
  int32_t* out_p = out + static_cast<size_t>(p) * n_evals;
  const uint32_t stride = gridDim.x * blockDim.x;
  const uint32_t stride_t = stride / S, stride_s = stride - stride_t * S;
  uint32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  uint32_t t = i / S, s = i - t * S;
  for (; i < n_evals; i += stride) {
    out_p[i] = static_cast<int32_t>(b.low32(s, t << 3) & chunk_mask);
    s += stride_s;
    t += stride_t;
    if (s >= S) {
      s -= S;
      ++t;
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2) aes_mmo_points_kernel(
    const uint32_t* __restrict__ round_keys,  // (P, 44) little-endian words
    const uint32_t* __restrict__ tags,        // (P, L)
    const uint32_t* __restrict__ xs,          // (P, L)
    int32_t* __restrict__ out,                // (P, L)
    uint32_t L, uint32_t chunk_mask) {
  extern __shared__ uint32_t te[];            // kTablesBytes
  AES_MARK(0);
  const uint32_t p = blockIdx.y;
  MmoBlock b;
  b.setup(te, round_keys + p * 44);
  const size_t base = static_cast<size_t>(p) * L;
  const uint32_t* tags_p = tags + base;
  const uint32_t* xs_p = xs + base;
  int32_t* out_p = out + base;
  const uint32_t stride = gridDim.x * blockDim.x;
  for (uint32_t i = blockIdx.x * blockDim.x + threadIdx.x; i < L; i += stride) {
    // (tag << 35) + x: the tag's bits above 28 leave the 64-bit input, as
    // the u32 shift of the TPU kernel drops them
    out_p[i] = static_cast<int32_t>(b.low32(__ldg(xs_p + i),
                                            __ldg(tags_p + i) << 3) &
                                    chunk_mask);
  }
  AES_MARK(3);
}

// The launch floor K5 is measured against: no work, K5's launch shape.
__global__ void __launch_bounds__(kThreads, 2) aes_empty_kernel() {}

// Where `kernel` (kThreads threads, kTablesBytes of dynamic shared memory)
// runs on the current device: its SMs and the blocks each holds at once,
// into *res; the kernel is opted in to its shared memory on the device's
// first call, and the answer kept in `cache` (one entry a device) for the
// next.
constexpr int kMaxDevices = 64;
struct Residency {
  uint32_t sms, per_sm;
};
static cudaError_t residency(const void* kernel, Residency* cache,
                             Residency* res) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < kMaxDevices && cache[device].sms != 0) {
    *res = cache[device];
    return cudaSuccess;
  }
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kTablesBytes);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, kTablesBytes);
  }
  if (err != cudaSuccess) return err;
  *res = Residency{static_cast<uint32_t>(sms), static_cast<uint32_t>(per_sm)};
  if (device < kMaxDevices) cache[device] = *res;
  return cudaSuccess;
}

// K5's launch for P lists of L points, into *grid and *threads. Points
// that fill fewer than one block of kThreads an SM are spread one block an
// SM, each of as few threads (a multiple of 32, at least 128) as its share
// needs, so that each SM looks up only its share; more points take blocks
// of kThreads, at most a whole wave of resident blocks (floor(wave / P) a
// partition).
static cudaError_t points_launch(const void* kernel, Residency* cache, int P,
                                 int L, dim3* grid, uint32_t* threads) {
  Residency r{};
  const cudaError_t err = residency(kernel, cache, &r);
  if (err != cudaSuccess) return err;
  const uint32_t n = static_cast<uint32_t>(L), parts = static_cast<uint32_t>(P);
  uint32_t blocks = (n + kThreads - 1) / kThreads;
  *threads = kThreads;
  if (blocks * parts < r.sms) {
    const uint32_t share = (n + r.sms / parts - 1) / (r.sms / parts);
    *threads = (share + 31) / 32 * 32;
    if (*threads < 128) *threads = 128;
    if (*threads > kThreads) *threads = kThreads;
    blocks = (n + *threads - 1) / *threads;
  } else if (blocks > r.sms * r.per_sm / parts) {
    blocks = r.sms * r.per_sm / parts;
  }
  if (blocks == 0) blocks = 1;
  *grid = dim3(blocks, static_cast<unsigned int>(P));
  return cudaSuccess;
}

// round_keys: (P, 44) u32 device words; out: (P, T, S) int32 device buffer.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int aes_mmo_tables(const void* round_keys, void* out, int P, int T,
                              int S, unsigned int chunk_mask, void* stream) {
  static Residency cache[kMaxDevices] = {};
  if (P <= 0 || T <= 0 || S <= 0) return 0;
  const uint32_t n_evals = static_cast<uint32_t>(T) * static_cast<uint32_t>(S);
  // one wave: the blocks the card holds at once, shared by the partitions
  Residency r{};
  const cudaError_t err = residency(
      reinterpret_cast<const void*>(aes_mmo_tables_kernel), cache, &r);
  if (err != cudaSuccess) return static_cast<int>(err);
  const uint32_t wave = r.sms * r.per_sm;
  uint32_t blocks = (wave + P - 1) / static_cast<uint32_t>(P);
  const uint32_t needed = (n_evals + kThreads - 1) / kThreads;
  if (blocks > needed) blocks = needed;
  if (blocks == 0) blocks = 1;
  aes_mmo_tables_kernel<<<dim3(blocks, static_cast<unsigned int>(P)),
                          kThreads, kTablesBytes,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(round_keys), static_cast<int32_t*>(out),
      n_evals, static_cast<uint32_t>(S), chunk_mask);
  return static_cast<int>(cudaGetLastError());
}

// round_keys: (P, 44) u32 device words; tags, xs: (P, L) u32 device words;
// out: (P, L) int32 device buffer. Returns the launch's cudaError_t.
static Residency points_cache[kMaxDevices] = {};
extern "C" int aes_mmo_points(const void* round_keys, const void* tags,
                              const void* xs, void* out, int P, int L,
                              unsigned int chunk_mask, void* stream) {
  if (P <= 0 || L <= 0) return 0;
  dim3 grid;
  uint32_t threads = 0;
  const cudaError_t err = points_launch(
      reinterpret_cast<const void*>(aes_mmo_points_kernel), points_cache, P,
      L, &grid, &threads);
  if (err != cudaSuccess) return static_cast<int>(err);
  aes_mmo_points_kernel<<<grid, threads, kTablesBytes,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(round_keys),
      static_cast<const uint32_t*>(tags), static_cast<const uint32_t*>(xs),
      static_cast<int32_t*>(out), static_cast<uint32_t>(L), chunk_mask);
  return static_cast<int>(cudaGetLastError());
}

// An empty kernel launched as aes_mmo_points would be for (P, L): its grid,
// threads and shared memory, no work. Returns the launch's cudaError_t.
extern "C" int aes_mmo_points_floor(int P, int L, void* stream) {
  // its own residency only opts the empty kernel in to the shared memory
  static Residency cache[kMaxDevices] = {};
  if (P <= 0 || L <= 0) return 0;
  dim3 grid;
  uint32_t threads = 0;
  Residency own{};
  cudaError_t err = residency(
      reinterpret_cast<const void*>(aes_empty_kernel), cache, &own);
  if (err == cudaSuccess) {
    err = points_launch(reinterpret_cast<const void*>(aes_mmo_points_kernel),
                        points_cache, P, L, &grid, &threads);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  aes_empty_kernel<<<grid, threads, kTablesBytes,
                     static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
