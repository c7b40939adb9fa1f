// K1 and K5: AES-128-MMO PRF evaluations with per-partition keys, sm_90a.
//
// PRF_key(t, x) = low32(AES-128-MMO_key(LE64((t << 35) + x) || 0^8)): the
// input block is the words (x, t << 3, 0, 0) (pianopir/util.go:157-165) and
// MMO is E_k(m) ^ m, so the low word is the cipher's word 0 ^ x. Two entry
// points, one round function (mmo_low32):
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
// Bound on the H100: shared-memory lookups and integer work, about 150
// lookups per evaluation (16 per round for rounds 1-9, 4 S-box reads for word
// 0 of the last round; only the low output word is needed). K1 writes 4 bytes
// per evaluation and K5 reads 8 more, so device memory is not the limit.
//
// K1's design (aes_mmo_tables_kernel): lookups without bank conflicts. For
// every byte x the block holds 32 copies of Te0[x] and 32 of Te2[x], at byte
// address x * 256 + table * 128 + lane * 4 (64 KB, two CTAs of 512 threads an
// SM). Lane l reads only its own copies, which lie in bank l whatever byte it
// looks up: one wavefront per warp-wide lookup, where random bytes into one
// 256-word table take 3-4. The address is one byte permute (PRMT) of the
// state word and the lane's offset. Te1 and Te3 are Te0 and Te2 rotated by 8
// bits, so a column is Te0[a] ^ Te2[c] ^ rot8(Te0[b] ^ Te2[d] ^ rotr8(key)):
// 4 PRMT, 4 LDS and 3 logic operations. The last round's S-box byte is a byte
// of Te0[x] or Te2[x], so there is no other table. The round keys sit in
// registers; round 1's eight lookups on words 2 and 3 of the block (0 before
// whitening) are the same for the whole partition and are folded into its
// round key once. The grid is one wave of resident blocks (SMs x blocks an
// SM holds) shared by the partitions, each striding over its partition's
// lattice, so each builds its tables once. Per evaluation: 140 lookups
// against about 260 integer operations, so the lookups (32 words a clock an
// SM) stay the limit, ahead of integer issue (64 a clock).
//
// K5 (aes_mmo_points_kernel) keeps the first form: four 1 KB T-tables, the
// S-box and the round keys in shared memory, built once per block. At the
// online shapes it runs (P = 16, 1,488 to 23,808 points a partition) the
// launch and the per-block table build are a large share of its time, which
// K1's 64 KB tables would raise.
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

constexpr int kThreads = 256;
constexpr int kMaxBlocksPerPartition = 512;

__device__ __forceinline__ uint32_t xtime(uint32_t b) {
  return ((b << 1) ^ ((b & 0x80u) ? 0x1bu : 0u)) & 0xffu;
}

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int n) {
  return (x << n) | (x >> (32 - n));
}

struct AesTables {
  uint32_t te[4][256];
  uint32_t sbox[256];
  uint32_t rk[44];
};

// Fills the block's tables with partition p's round keys; ends in a barrier.
__device__ void load_tables(AesTables& sm, const uint32_t* __restrict__ round_keys,
                            uint32_t p) {
  for (uint32_t i = threadIdx.x; i < 256; i += blockDim.x) {
    const uint32_t s = kSbox[i];
    const uint32_t s2 = xtime(s);
    // column contribution of a row-0 input byte: (2s, s, s, 3s)
    const uint32_t w = s2 | (s << 8) | (s << 16) | ((s2 ^ s) << 24);
    sm.te[0][i] = w;
    sm.te[1][i] = rotl32(w, 8);
    sm.te[2][i] = rotl32(w, 16);
    sm.te[3][i] = rotl32(w, 24);
    sm.sbox[i] = s;
  }
  for (uint32_t i = threadIdx.x; i < 44; i += blockDim.x) {
    sm.rk[i] = round_keys[p * 44 + i];
  }
  __syncthreads();
}

// Low word of AES-128-MMO of the block (x, hi, 0, 0) under the block's key.
__device__ __forceinline__ uint32_t mmo_low32(const AesTables& sm, uint32_t x,
                                              uint32_t hi) {
  uint32_t w0 = x ^ sm.rk[0];
  uint32_t w1 = hi ^ sm.rk[1];
  uint32_t w2 = sm.rk[2];
  uint32_t w3 = sm.rk[3];
#pragma unroll
  for (int r = 1; r < 10; ++r) {
    // SubBytes + ShiftRows + MixColumns: output column c takes row j
    // from input column (c + j) % 4
    const uint32_t n0 = sm.te[0][w0 & 0xff] ^ sm.te[1][(w1 >> 8) & 0xff] ^
                        sm.te[2][(w2 >> 16) & 0xff] ^ sm.te[3][w3 >> 24] ^ sm.rk[4 * r];
    const uint32_t n1 = sm.te[0][w1 & 0xff] ^ sm.te[1][(w2 >> 8) & 0xff] ^
                        sm.te[2][(w3 >> 16) & 0xff] ^ sm.te[3][w0 >> 24] ^ sm.rk[4 * r + 1];
    const uint32_t n2 = sm.te[0][w2 & 0xff] ^ sm.te[1][(w3 >> 8) & 0xff] ^
                        sm.te[2][(w0 >> 16) & 0xff] ^ sm.te[3][w1 >> 24] ^ sm.rk[4 * r + 2];
    const uint32_t n3 = sm.te[0][w3 & 0xff] ^ sm.te[1][(w0 >> 8) & 0xff] ^
                        sm.te[2][(w1 >> 16) & 0xff] ^ sm.te[3][w2 >> 24] ^ sm.rk[4 * r + 3];
    w0 = n0;
    w1 = n1;
    w2 = n2;
    w3 = n3;
  }
  // last round, column 0 only: SubBytes + ShiftRows + round key 10
  const uint32_t c0 = (sm.sbox[w0 & 0xff] | (sm.sbox[(w1 >> 8) & 0xff] << 8) |
                       (sm.sbox[(w2 >> 16) & 0xff] << 16) |
                       (sm.sbox[w3 >> 24] << 24)) ^ sm.rk[40];
  return c0 ^ x;  // MMO feed-forward
}

// K1's tables: for every byte x, 32 copies of Te0[x] and 32 of Te2[x], at
// byte address x * 256 + half * 128 + lane * 4 (64 KB). Lane l reads only its
// own copies, in bank l, so a warp-wide lookup is one wavefront; and the
// address is one byte permute of the state word and the lane's offset.
constexpr int kTablesThreads = 512;
constexpr int kTablesBytes = 256 * 256;
constexpr uint32_t kTe2 = 128;   // byte offset of the Te2 copies in a row

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

__global__ void __launch_bounds__(kTablesThreads, 2) aes_mmo_tables_kernel(
    const uint32_t* __restrict__ round_keys,  // (P, 44) little-endian words
    int32_t* __restrict__ out,                // (P, T, S)
    uint32_t n_evals,                         // T * S
    uint32_t S, uint32_t chunk_mask) {
  extern __shared__ uint32_t te[];            // kTablesBytes
  for (uint32_t i = threadIdx.x; i < kTablesBytes / 4; i += blockDim.x) {
    const uint32_t s = kSbox[i / 64];
    const uint32_t s2 = xtime(s);
    // column contribution of a row-0 input byte: (2s, s, s, 3s)
    const uint32_t w = s2 | (s << 8) | (s << 16) | ((s2 ^ s) << 24);
    te[i] = (i & 32) ? rot(w, 2) : w;
  }
  const uint32_t p = blockIdx.y;
  const uint32_t* rk_p = round_keys + p * 44;
  const uint32_t rk0 = __ldg(rk_p), rk1 = __ldg(rk_p + 1), rk40 = __ldg(rk_p + 40);
  uint32_t kr[36];   // round keys 1-9 rotated right by 8
#pragma unroll
  for (int i = 0; i < 36; ++i) kr[i] = rot(__ldg(rk_p + 4 + i), 3);
  __syncthreads();
  const uint8_t* tab = reinterpret_cast<const uint8_t*>(te);
  const uint32_t o0 = (threadIdx.x & 31) * 4, o2 = o0 | kTe2;
  // round 1 on the words 2 and 3 of the block, rk[2] and rk[3] after
  // whitening: the same for every lattice point, folded into round key 1
  {
    const uint32_t w2 = __ldg(rk_p + 2), w3 = __ldg(rk_p + 3);
    const uint32_t t0 = load(tab, entry<0>(w2, o0)), t1 = load(tab, entry<0>(w3, o0));
    kr[0] ^= rot(load(tab, entry<2>(w2, o2)) ^ rot(load(tab, entry<3>(w3, o2)), 1), 3);
    kr[1] ^= rot(rot(load(tab, entry<1>(w2, o0)), 1) ^ load(tab, entry<2>(w3, o2)), 3);
    kr[2] ^= rot(t0 ^ rot(load(tab, entry<1>(w3, o0)), 1), 3);
    kr[3] ^= rot(t1 ^ rot(load(tab, entry<3>(w2, o2)), 1), 3);
  }

  int32_t* out_p = out + static_cast<size_t>(p) * n_evals;
  const uint32_t stride = gridDim.x * blockDim.x;
  const uint32_t stride_t = stride / S, stride_s = stride - stride_t * S;
  uint32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  uint32_t t = i / S, s = i - t * S;
  for (; i < n_evals; i += stride) {
    // (s, t << 3, 0, 0) whitened; round 1 looks up words 0 and 1 only:
    // column c = (Te0[b0 of c] ^ Te1[b1 of c+1] ^ Te2[b2 of c+2] ^ Te3[b3
    // of c+3]), the words-2-and-3 terms in kr[0..3]
    const uint32_t x0 = s ^ rk0, x1 = (t << 3) ^ rk1;
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
    out_p[i] = static_cast<int32_t>((c0 ^ rk40 ^ s) & chunk_mask);
    s += stride_s;
    t += stride_t;
    if (s >= S) {
      s -= S;
      ++t;
    }
  }
}

__global__ void __launch_bounds__(kThreads) aes_mmo_points_kernel(
    const uint32_t* __restrict__ round_keys,  // (P, 44) little-endian words
    const uint32_t* __restrict__ tags,        // (P, L)
    const uint32_t* __restrict__ xs,          // (P, L)
    int32_t* __restrict__ out,                // (P, L)
    uint32_t L, uint32_t chunk_mask) {
  __shared__ AesTables sm;
  const uint32_t p = blockIdx.y;
  load_tables(sm, round_keys, p);
  const size_t base = static_cast<size_t>(p) * L;
  const uint32_t stride = gridDim.x * blockDim.x;
  for (uint32_t i = blockIdx.x * blockDim.x + threadIdx.x; i < L; i += stride) {
    // (tag << 35) + x: the tag's bits above 28 leave the 64-bit input, as
    // the u32 shift of the TPU kernel drops them
    const uint32_t v = mmo_low32(sm, xs[base + i], tags[base + i] << 3);
    out[base + i] = static_cast<int32_t>(v & chunk_mask);
  }
}

static dim3 grid_for(uint32_t n, int P) {
  uint32_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocksPerPartition) blocks = kMaxBlocksPerPartition;
  return dim3(blocks, static_cast<unsigned int>(P));
}

// The blocks of aes_mmo_tables_kernel the current device holds at once (SMs
// x resident blocks), into *wave; the kernel is opted in to its shared
// memory on the device's first call, and the answer kept for the next.
static cudaError_t tables_wave(uint32_t* wave) {
  constexpr int kMaxDevices = 64;
  static uint32_t waves[kMaxDevices] = {};
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < kMaxDevices && waves[device] != 0) {
    *wave = waves[device];
    return cudaSuccess;
  }
  err = cudaFuncSetAttribute(aes_mmo_tables_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kTablesBytes);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, aes_mmo_tables_kernel, kTablesThreads, kTablesBytes);
  }
  if (err != cudaSuccess) return err;
  *wave = static_cast<uint32_t>(sms) * static_cast<uint32_t>(per_sm);
  if (device < kMaxDevices) waves[device] = *wave;
  return cudaSuccess;
}

// round_keys: (P, 44) u32 device words; out: (P, T, S) int32 device buffer.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int aes_mmo_tables(const void* round_keys, void* out, int P, int T,
                              int S, unsigned int chunk_mask, void* stream) {
  if (P <= 0 || T <= 0 || S <= 0) return 0;
  const uint32_t n_evals = static_cast<uint32_t>(T) * static_cast<uint32_t>(S);
  // one wave: the blocks the card holds at once, shared by the partitions
  uint32_t wave = 0;
  const cudaError_t err = tables_wave(&wave);
  if (err != cudaSuccess) return static_cast<int>(err);
  uint32_t blocks = (wave + P - 1) / static_cast<uint32_t>(P);
  const uint32_t needed = (n_evals + kTablesThreads - 1) / kTablesThreads;
  if (blocks > needed) blocks = needed;
  if (blocks == 0) blocks = 1;
  aes_mmo_tables_kernel<<<dim3(blocks, static_cast<unsigned int>(P)),
                          kTablesThreads, kTablesBytes,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(round_keys), static_cast<int32_t*>(out),
      n_evals, static_cast<uint32_t>(S), chunk_mask);
  return static_cast<int>(cudaGetLastError());
}

// round_keys: (P, 44) u32 device words; tags, xs: (P, L) u32 device words;
// out: (P, L) int32 device buffer. Returns the launch's cudaError_t.
extern "C" int aes_mmo_points(const void* round_keys, const void* tags,
                              const void* xs, void* out, int P, int L,
                              unsigned int chunk_mask, void* stream) {
  if (P <= 0 || L <= 0) return 0;
  aes_mmo_points_kernel<<<grid_for(static_cast<uint32_t>(L), P), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(round_keys),
      static_cast<const uint32_t*>(tags), static_cast<const uint32_t*>(xs),
      static_cast<int32_t*>(out), static_cast<uint32_t>(L), chunk_mask);
  return static_cast<int>(cudaGetLastError());
}
