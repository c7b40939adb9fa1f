// K3 and K4: the PIR client's slot selection, sm_90a.
//
// Replace the Pallas kernels of pacmann_tpu/ops/protocol_kernels.py:
//   K4 `_claim_kernel` (claim_select): Phase A (pir.go:404-419). Round q
//      takes the smallest primary slot h with slot_col[p, chunk_q, h] ==
//      off_q, not programmed for chunk_q, and not claimed by an earlier round.
//   K3 `_select_full_kernel` (select_full): the same claim, then the
//      replacement budget (group index ig = hist[chunk] + earlier found
//      rounds of that chunk, -1 if the round found nothing), the global
//      budget (rank among admitted rounds < max_q - finished), and the
//      round's (S,) query row: the hit slot's offset set, its programmed
//      point, the replacement offset at the round's own chunk, or the dummy
//      row when the round is not served.
//
// Both run one claim pass (claim_pass_kernel), K3 with its budgets and
// rows, K4 with its own inputs. The rounds interact only through the
// claimed set. A round's eligible slots (col == off and not programmed for
// its chunk) do not depend on earlier rounds, and at most q earlier rounds
// can have claimed one of them. So one launch runs on a cluster of G CTAs
// per partition (G = ceil(Q / 16), at most 8) and takes the rounds in
// windows of kWindow, each in three phases with the cluster barrier between
// them:
//   1. candidates, parallel over the window's rounds: a warp per round scans
//      its row in ascending h (8 loads in flight a lane, 4 slots a load where
//      the rows are 16-byte aligned) and keeps the first K = min(Q, 16)
//      eligible slots in order: slots with col == off gather in a warp buffer
//      by ballot + popc, and their program points are checked 32 at a time.
//      The lists go as 16-bit slot indices, with each round's count, chunk,
//      offset and (K3) hist[chunk], into the shared memory of the cluster's
//      CTA 0 (distributed shared memory);
//   2. the serial walk, one warp of CTA 0: round q takes the first of its
//      candidates not in the claimed set (a bitmap of Hp bits), one lane a
//      candidate. A round whose list is full (K) and whose K candidates are
//      all claimed scans its row on from the K-th candidate (the row the
//      walk scanned last from after the slot that scan took) for the first
//      eligible slot that is not claimed: exact for any data. K3 then
//      updates found[chunk], the group index, ok_r, ok_q and the rank in
//      round order. The claimed set, found and the rank carry over to the
//      next window;
//   3. the outputs, parallel: every CTA of the cluster writes those of its
//      rounds from the walk's results, read from CTA 0: K4 hit and found,
//      K3 its (Q, P) outputs and the query rows.
// So the shared-memory plan holds one window, whatever Q is, and is the same
// for both kernels.
// K4's inputs are the round's chunk, offset and realness as given: a round
// that is not real, or whose chunk lies outside [0, S), reads nothing and
// finds nothing; an offset may be any int32 (phase 1 pads its loads with
// ~off, which never equals off).
// Bound on the H100: latency. At SIFT1M shape a round's row has about Hp / C
// = 7 eligible slots, so a round rarely finds its K candidates claimed;
// phase 1 is the rows' L2 round trips, spread over P x G CTAs, and the walk
// a few shared-memory round trips a round (about 300 clocks). Nothing here
// syncs the host.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFullMask = 0xffffffffu;
// candidates kept per round, rounds a window, CTAs per partition at most
// (the portable cluster size), row loads in flight per lane in phase 1
constexpr int kCandidates = 16;
constexpr int kWindow = 256;
constexpr int kMaxCluster = 8;
constexpr int kScanUnroll = 8;
// a warp's buffer of slots with col == off awaiting their program-point
// check: fewer than 32 plus one group of kScanUnroll's loads (128)
constexpr int kMatchBuf = 160;
// slot indices are kept in 16 bits
constexpr int kMaxSlots = 1 << 16;
// dynamic shared memory a CTA gets without opting in; above it each kernel
// is opted in, up to the device's limit
// cudaDevAttrMaxSharedMemoryPerBlockOptin (232,448 B on an H100)
constexpr size_t kDefaultSmem = 48 * 1024;

struct Args {
  // both kernels
  const int32_t* slot_col;   // (P, S, Hp)
  const int32_t* prog;       // (P, Hp)
  int32_t* hit;              // (Q, P)
  int P, S, Hp, Q, C, dpp;
  // K4 inputs and output
  const int32_t* chunk_q;    // (Q, P)
  const int32_t* off_q;      // (Q, P)
  const uint8_t* real_q;     // (Q, P) bool
  uint8_t* found;            // (Q, P) bool
  // K3 inputs
  const int32_t* tag;        // (P, Hp)
  const int32_t* table;      // (P, T, S)
  const int32_t* repl_idx;   // (P, S, R)
  const int32_t* hist;       // (P, S)
  const int32_t* finished;   // (P,)
  const int32_t* idx_q;      // (Q, P), -1 = dummy round
  const int32_t* rnd;        // (Q, P, S)
  // K3 outputs
  int32_t* qs;               // (Q, P, S)
  uint8_t* ok_q;             // (Q, P) bool
  uint8_t* ok_r;             // (Q, P) bool
  int32_t* ig;               // (Q, P)
  int32_t* chunk;            // (Q, P)
  int32_t* idxu;             // (Q, P)
  int T, R, max_q;
};

__host__ __device__ static int candidates(int Q) {
  return Q < kCandidates ? Q : kCandidates;
}

// The plan of K3 and K4, the same in every CTA (CTA 0 uses all of it): per
// round of a window a 16-byte record from phase 1 and one from the walk,
// kCandidates 16-bit candidates; the claimed bitmap; found rounds per chunk
// (K3); each warp's buffer of kMatchBuf slots
static size_t smem_plan(int Hp, int S) {
  return static_cast<size_t>(kWindow) * (32 + 2 * kCandidates) +
         static_cast<size_t>((Hp + 31) / 32) * 4 +
         static_cast<size_t>(S) * 4 + 2 * kWarps * kMatchBuf;
}

#ifdef K3_PHASE_CLOCKS
// Built only to time K3's phases (scripts/kernel_ab.py --phases): the SM
// clock of CTA 0 of partition 0 at each mark, the latest of its warps. Row
// w < kClockWindows holds window w's marks (0 its start, 1 and 2 around the
// barrier after phase 1, 3 and 4 around the one after the walk, 5 the end
// of phase 3); row kClockWindows the kernel's (0 its start, 1 and 2 around
// the first barrier, 3 and 4 around the last). K4's launches record none.
constexpr int kClockWindows = 32;
__device__ unsigned long long k3_clocks[kClockWindows + 1][6];
#define K3_MARK(w, k)                                                    \
  do {                                                                   \
    if (kSelect && p == 0 && rank == 0 && lane == 0 &&                   \
        (w) <= kClockWindows) {                                          \
      atomicMax(&k3_clocks[w][k],                                        \
                static_cast<unsigned long long>(clock64()));             \
    }                                                                    \
  } while (0)
#define K3_WINDOW_MARK(q0, k)                                      \
  K3_MARK((q0) / kWindow < kClockWindows ? (q0) / kWindow          \
                                         : kClockWindows + 1, k)
extern "C" int k3_clocks_zero() {
  static const unsigned long long zero[kClockWindows + 1][6] = {};
  return static_cast<int>(cudaMemcpyToSymbol(k3_clocks, zero, sizeof(zero)));
}
extern "C" int k3_clocks_read(void* host) {
  return static_cast<int>(
      cudaMemcpyFromSymbol(host, k3_clocks, sizeof(k3_clocks)));
}
#else
#define K3_MARK(w, k) \
  do {                \
  } while (0)
#define K3_WINDOW_MARK(q0, k) \
  do {                        \
  } while (0)
#endif

static int cluster_size(int Q) {
  const int g = (Q + kWarps - 1) / kWarps;
  return g < 1 ? 1 : (g > kMaxCluster ? kMaxCluster : g);
}

__device__ __forceinline__ int programmed_chunk(int v, unsigned uC, int dpp) {
  return v != dpp ? static_cast<int>(static_cast<unsigned>(v) / uC) : -1;
}

// One warp: appends the slots buf[0, nm) (each with col == off) that are not
// programmed for chunk ck to cand[n, K), in order, one program-point load a
// lane per 32 slots; returns the new n.
__device__ int keep_eligible(const uint16_t* buf, int nm,
                             const int32_t* __restrict__ prog_p, unsigned uC,
                             int dpp, int ck, int n, int K, uint16_t* cand,
                             int lane) {
  const unsigned lower = (1u << lane) - 1u;
  __syncwarp();
  for (int i = 0; i < nm && n < K; i += 32) {
    const int at = i + lane;
    const int h = at < nm ? buf[at] : 0;
    const bool e =
        at < nm && programmed_chunk(__ldg(prog_p + h), uC, dpp) != ck;
    const unsigned m = __ballot_sync(kFullMask, e);
    const int pos = n + __popc(m & lower);
    if (e && pos < K) cand[pos] = static_cast<uint16_t>(h);
    n += __popc(m);
  }
  __syncwarp();
  return n;
}

// One warp: the first (at most) K eligible slots h >= start of the row `col`
// (col[h] == off, not programmed for chunk ck, and, given `claimed`, not
// claimed), in ascending order, into cand[0, K); returns how many. With
// `vec` (Hp % 4 == 0 and the row 16-byte aligned) a lane loads 4 slots at
// once, lane-major; else one. Slots with col == off gather in the warp's
// buffer `buf` (kMatchBuf) and have their program points checked 32 at a
// time, or as soon as they could complete the K. Phase 1 calls it on a whole
// row, the walk on the rest of a row whose K candidates are all claimed.
__device__ int collect_candidates(const int32_t* __restrict__ col,
                                  const int32_t* __restrict__ prog_p, int Hp,
                                  bool vec, int start, int off, int ck,
                                  unsigned uC, int dpp,
                                  const uint32_t* claimed, int K,
                                  uint16_t* cand, uint16_t* buf, int lane) {
  const unsigned lower = (1u << lane) - 1u;
  const int per_lane = vec ? 4 : 1;
  const int step = 32 * per_lane;
  // fills what lies past the row or past a scalar load: never equal to off
  const int pad = ~off;
  int n = 0, nm = 0;
  for (int base = start - start % per_lane; base < Hp && n < K;
       base += kScanUnroll * step) {
    int4 v[kScanUnroll];
#pragma unroll
    for (int j = 0; j < kScanUnroll; ++j) {
      const int h = base + j * step + lane * per_lane;
      v[j] = make_int4(pad, pad, pad, pad);
      if (h < Hp) {
        if (vec) {
          v[j] = __ldg(reinterpret_cast<const int4*>(col + h));
        } else {
          v[j].x = __ldg(col + h);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kScanUnroll; ++j) {
      const int h = base + j * step + lane * per_lane;
      unsigned bits = (v[j].x == off ? 1u : 0u) | (v[j].y == off ? 2u : 0u) |
                      (v[j].z == off ? 4u : 0u) | (v[j].w == off ? 8u : 0u);
      if (h < start) bits &= ~0u << (start - h);
      if (__ballot_sync(kFullMask, bits != 0) == 0) continue;
      if (claimed) {
        for (int b = 0; b < per_lane; ++b) {
          const int hb = h + b;
          if (((bits >> b) & 1u) && ((claimed[hb >> 5] >> (hb & 31)) & 1u)) {
            bits &= ~(1u << b);
          }
        }
      }
      // this lane's count, and the counts of the lanes before it
      const int c = __popc(bits);
      const unsigned c0 = __ballot_sync(kFullMask, c & 1);
      const unsigned c1 = __ballot_sync(kFullMask, c & 2);
      const unsigned c2 = __ballot_sync(kFullMask, c & 4);
      int at = nm + __popc(c0 & lower) + 2 * __popc(c1 & lower) +
               4 * __popc(c2 & lower);
      for (int b = 0; b < per_lane; ++b) {
        if ((bits >> b) & 1u) buf[at++] = static_cast<uint16_t>(h + b);
      }
      nm += __popc(c0) + 2 * __popc(c1) + 4 * __popc(c2);
      if (nm >= 32 || n + nm >= K) {
        n = keep_eligible(buf, nm, prog_p, uC, dpp, ck, n, K, cand, lane);
        nm = 0;
        if (n >= K) break;
      }
    }
  }
  if (nm > 0 && n < K) {
    n = keep_eligible(buf, nm, prog_p, uC, dpp, ck, n, K, cand, lane);
  }
  return n < K ? n : K;
}

// The claim pass: K3 (kSelect) or K4.
template <bool kSelect>
__global__ void __launch_bounds__(kThreads) claim_pass_kernel(const Args a) {
  extern __shared__ int4 smem4[];
  cg::cluster_group cluster = cg::this_cluster();
  const int G = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int p = static_cast<int>(blockIdx.x) / G;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  K3_MARK(kClockWindows, 0);
  const int Q = a.Q, Hp = a.Hp, S = a.S, K = candidates(Q);
  const int words = (Hp + 31) / 32;
  // (kWindow) from phase 1: chunk, offset, hist[chunk], count | real << 8 |
  // in range << 9
  int4* rounds = smem4;
  // (kWindow) from the walk: hit, gc, ok_q | ok_r << 1 | found << 2, chunk
  int4* results = rounds + kWindow;
  uint32_t* claimed = reinterpret_cast<uint32_t*>(results + kWindow);
  int32_t* found_c = reinterpret_cast<int32_t*>(claimed + words);  // (S)
  uint16_t* cand = reinterpret_cast<uint16_t*>(found_c + S);  // (kWindow, K)
  uint16_t* match_buf = cand + kWindow * kCandidates;  // (kWarps, kMatchBuf)
  int4* rounds0 = cluster.map_shared_rank(rounds, 0);
  const int4* results0 = cluster.map_shared_rank(results, 0);
  uint16_t* cand0 = cluster.map_shared_rank(cand, 0);

  uint16_t* buf = match_buf + warp * kMatchBuf;
  const unsigned uC = static_cast<unsigned>(a.C);
  // every row starts 16-byte aligned: a lane loads 4 slots at once
  const bool vec = Hp % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(a.slot_col) % 16 == 0;
  const int32_t* prog_p = a.prog + static_cast<size_t>(p) * Hp;
  if (rank == 0) {
    for (int i = tid; i < words; i += kThreads) claimed[i] = 0;
    if (kSelect) {
      for (int s = tid; s < S; s += kThreads) found_c[s] = 0;
    }
  }
  // every CTA of the cluster runs before any writes to CTA 0's memory
  K3_MARK(kClockWindows, 1);
  cluster.sync();
  K3_MARK(kClockWindows, 2);

  // the walk's admitted rounds so far, and the row (chunk, offset) it last
  // scanned on with the slot that scan starts from next
  int rankp = 0, scan_ck = -1, scan_off = 0, scan_from = 0;
  for (int q0 = 0; q0 < Q; q0 += kWindow) {
    const int nq = Q - q0 < kWindow ? Q - q0 : kWindow;
    K3_WINDOW_MARK(q0, 0);
    // 1. candidates, a warp per round, the rounds spread over the cluster.
    // Round q0 + i's record and list go to slot i of CTA 0's window.
    for (int i = rank + G * warp; i < nq; i += G * kWarps) {
      const size_t qp = static_cast<size_t>(q0 + i) * a.P + p;
      int ck, off, u = 0;
      bool real;
      if (kSelect) {
        const int idx = a.idx_q[qp];
        real = idx >= 0;
        u = real ? idx : 0;
        ck = u / a.C;
        off = u % a.C;
      } else {
        ck = a.chunk_q[qp];
        off = a.off_q[qp];
        real = a.real_q[qp] != 0;
      }
      // a chunk outside [0, S) is outside the contract: read nothing for it
      const bool in_range = ck >= 0 && ck < S;
      const int hown =
          kSelect && in_range ? a.hist[static_cast<size_t>(p) * S + ck] : 0;
      int n = 0;
      if (real && in_range) {
        n = collect_candidates(
            a.slot_col + (static_cast<size_t>(p) * S + ck) * Hp, prog_p, Hp,
            vec, 0, off, ck, uC, a.dpp, nullptr, K,
            cand0 + static_cast<size_t>(i) * K, buf, lane);
      }
      if (lane == 0) {
        rounds0[i] = make_int4(ck, off, hown, n | (real ? 1 << 8 : 0) |
                                                  (in_range ? 1 << 9 : 0));
        if (kSelect) {
          a.chunk[qp] = ck;
          a.idxu[qp] = u;
        }
      }
    }
    K3_WINDOW_MARK(q0, 1);
    cluster.sync();
    K3_WINDOW_MARK(q0, 2);

    // 2. the serial walk, one warp of CTA 0. Lane i holds round q's i-th
    // candidate. Round q + 1's record and candidates are loaded first (the
    // walk reads them only); each round's chain is then one claimed-word
    // load, a ballot, a shuffle and the claim.
    if (rank == 0 && warp == 0) {
      const int fin = kSelect ? a.finished[p] : 0;
      const int lane_k = lane < K ? lane : K - 1;
      int4 rd = rounds[0];
      int c = cand[lane_k];
      for (int i = 0; i < nq; ++i) {
        const int i1 = i + 1 < nq ? i + 1 : i;
        const int4 rd_next = rounds[i1];
        const int c_next = cand[static_cast<size_t>(i1) * K + lane_k];
        const int ck = rd.x, off = rd.y, n = rd.w & 0xff;
        const bool in_range = (rd.w >> 9) & 1;
        if (lane >= n) c = 0;
        const uint32_t word = claimed[c >> 5];
        const bool free_slot = lane < n && !((word >> (c & 31)) & 1u);
        // found_c was last written before the previous __syncwarp
        const int prev = kSelect && in_range ? found_c[ck] : 0;
        const unsigned m = __ballot_sync(kFullMask, free_slot);
        int h = -1;
        if (m) {
          const int src = __ffs(m) - 1;
          h = __shfl_sync(kFullMask, c, src);
          if (lane == src) claimed[c >> 5] = word | (1u << (c & 31));
        } else if (n == K) {
          // every kept candidate is claimed: the round's slot is the row's
          // first eligible slot after the K-th that is not claimed, if any.
          // Claims are never undone, so a row scanned on before resumes
          // after the slot that scan took. The round's list has been read:
          // its first entry takes the slot.
          const bool again = ck == scan_ck && off == scan_off;
          const int from =
              again ? scan_from : __shfl_sync(kFullMask, c, K - 1) + 1;
          uint16_t* slot = cand + static_cast<size_t>(i) * K;
          if (collect_candidates(
                  a.slot_col + (static_cast<size_t>(p) * S + ck) * Hp,
                  prog_p, Hp, vec, from, off, ck, uC, a.dpp, claimed, 1, slot,
                  buf, lane)) {
            h = *slot;
            if (lane == 0) claimed[h >> 5] |= 1u << (h & 31);
          }
          scan_ck = ck;
          scan_off = off;
          scan_from = h >= 0 ? h + 1 : Hp;
        }
        const bool fnd = h >= 0;   // a kept candidate implies a real round
        int flags = fnd ? 4 : 0, gc = 0;
        if (kSelect) {
          const int g = rd.z + prev - (fnd ? 0 : 1);
          const bool okr = fnd && g < a.R;
          const bool okq = okr && rankp < a.max_q - fin;
          rankp += okr ? 1 : 0;
          flags |= (okq ? 1 : 0) | (okr ? 2 : 0);
          gc = min(g, a.R - 1);
        }
        if (lane == 0) {
          if (kSelect && fnd) found_c[ck] = prev + 1;
          results[i] = make_int4(fnd ? h : 0, gc, flags, ck);
        }
        rd = rd_next;
        c = c_next;
        __syncwarp();
      }
    }
    K3_WINDOW_MARK(q0, 3);
    cluster.sync();
    K3_WINDOW_MARK(q0, 4);

    // 3. the outputs of the walk and, for K3, the query rows, a warp per
    // round, the rounds spread over the cluster. The next window's phase 1
    // writes only the records and lists, which the walk has read; its walk
    // writes the results after the barrier that ends that phase 1.
    for (int i = rank + G * warp; i < nq; i += G * kWarps) {
      const size_t qp = static_cast<size_t>(q0 + i) * a.P + p;
      const int4 r = results0[i];
      if (lane == 0) {
        a.hit[qp] = r.x;
        if (kSelect) {
          a.ok_q[qp] = r.z & 1;
          a.ok_r[qp] = (r.z >> 1) & 1;
          a.ig[qp] = r.y;
        } else {
          a.found[qp] = (r.z >> 2) & 1;
        }
      }
      if (!kSelect) continue;
      int32_t* out = a.qs + qp * S;
      if (r.z & 1) {
        // ok_q implies a found slot (0 <= chunk < S) and g < R; a negative
        // group index (hist < 0 is outside the contract) selects 0, as the
        // TPU kernel's one-hot select over r does, and reads nothing
        const int mh = r.x, gc = r.y, ck = r.w;
        const int htag = a.tag[static_cast<size_t>(p) * Hp + mh];
        const int hp = prog_p[mh];
        const int hs = programmed_chunk(hp, uC, a.dpp);
        const int hv = static_cast<int>(static_cast<unsigned>(hp) % uC);
        const int rv =
            gc >= 0
                ? static_cast<int>(
                      static_cast<unsigned>(
                          a.repl_idx[(static_cast<size_t>(p) * S + ck) * a.R +
                                     gc]) %
                      uC)
                : 0;
        const int32_t* trow =
            a.table + (static_cast<size_t>(p) * a.T + htag) * S;
        for (int s = lane; s < S; s += 32) {
          int v = trow[s];
          v = s == hs ? hv : v;
          v = s == ck ? rv : v;
          out[s] = v;
        }
      } else {
        const int32_t* dummy = a.rnd + qp * S;
        for (int s = lane; s < S; s += 32) out[s] = dummy[s];
      }
    }
    K3_WINDOW_MARK(q0, 5);
  }
  // CTA 0's shared memory stays until every CTA has read its results
  K3_MARK(kClockWindows, 3);
  cluster.sync();
  K3_MARK(kClockWindows, 4);
}

// The most dynamic shared memory one CTA may opt in to on `device`.
static int smem_optin(int device, int* bytes) {
  return static_cast<int>(cudaDeviceGetAttribute(
      bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device));
}

// Refuses a plan beyond the device's opt-in limit (cudaErrorInvalidValue);
// opts `kernel` in above the default before its launch.
template <typename Kernel>
static int prepare_smem(Kernel kernel, size_t smem) {
  if (smem <= kDefaultSmem) return 0;
  int device = 0, limit = 0;
  int err = static_cast<int>(cudaGetDevice(&device));
  if (err == 0) err = smem_optin(device, &limit);
  if (err != 0) return err;
  if (smem > static_cast<size_t>(limit)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

// The shared-memory limit K3 and K4 launch under on `device`, in bytes,
// into *bytes. Returns the cudaError_t of the query.
extern "C" int protocol_smem_limit(int device, int* bytes) {
  return smem_optin(device, bytes);
}

// Launches the claim pass on clusters of G CTAs per partition, G = 1
// included. Hp above 2^16 (16-bit slot indices) and plans beyond the
// device's opt-in shared memory are refused (cudaErrorInvalidValue).
template <bool kSelect>
static int launch_claim_pass(const Args& a, void* stream) {
  if (a.Hp <= 0 || a.Hp > kMaxSlots || a.S <= 0 || a.C <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (a.P <= 0 || a.Q <= 0) return 0;
  void (*kernel)(const Args) = claim_pass_kernel<kSelect>;
  const size_t smem = smem_plan(a.Hp, a.S);
  const int err = prepare_smem(kernel, smem);
  if (err != 0) return err;
  const int G = cluster_size(a.Q);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(a.P * G));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(G);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t launched = cudaLaunchKernelEx(&cfg, kernel, a);
  if (launched != cudaSuccess) return static_cast<int>(launched);
  return static_cast<int>(cudaGetLastError());
}

// K4. slot_col (P, S, Hp), prog (P, Hp), chunk_q/off_q (Q, P) int32,
// real_q (Q, P) bool -> hit (Q, P) int32, found (Q, P) bool. All device
// buffers, contiguous. Returns the launch's cudaError_t (0 on success).
extern "C" int claim_select(const void* slot_col, const void* prog,
                            const void* chunk_q, const void* off_q,
                            const void* real_q, void* hit, void* found, int P,
                            int S, int Hp, int Q, int C, int dpp,
                            void* stream) {
  Args a{};
  a.slot_col = static_cast<const int32_t*>(slot_col);
  a.prog = static_cast<const int32_t*>(prog);
  a.chunk_q = static_cast<const int32_t*>(chunk_q);
  a.off_q = static_cast<const int32_t*>(off_q);
  a.real_q = static_cast<const uint8_t*>(real_q);
  a.hit = static_cast<int32_t*>(hit);
  a.found = static_cast<uint8_t*>(found);
  a.P = P;
  a.S = S;
  a.Hp = Hp;
  a.Q = Q;
  a.C = C;
  a.dpp = dpp;
  return launch_claim_pass<false>(a, stream);
}

// K3. State slot_col (P, S, Hp), prog/tag (P, Hp), table (P, T, S),
// repl_idx (P, S, R), hist (P, S), finished (P,); idx_q (Q, P), rnd
// (Q, P, S) -> qs (Q, P, S), hit/ig/chunk/idxu (Q, P) int32, ok_q/ok_r
// (Q, P) bool. All int32 unless noted, device buffers, contiguous. Returns
// the launch's cudaError_t.
extern "C" int select_full(const void* slot_col, const void* prog,
                           const void* tag, const void* table,
                           const void* repl_idx, const void* hist,
                           const void* finished, const void* idx_q,
                           const void* rnd, void* qs, void* hit, void* ok_q,
                           void* ok_r, void* ig, void* chunk, void* idxu,
                           int P, int S, int Hp, int T, int R, int Q, int C,
                           int max_q, int dpp, void* stream) {
  Args a{};
  a.slot_col = static_cast<const int32_t*>(slot_col);
  a.prog = static_cast<const int32_t*>(prog);
  a.tag = static_cast<const int32_t*>(tag);
  a.table = static_cast<const int32_t*>(table);
  a.repl_idx = static_cast<const int32_t*>(repl_idx);
  a.hist = static_cast<const int32_t*>(hist);
  a.finished = static_cast<const int32_t*>(finished);
  a.idx_q = static_cast<const int32_t*>(idx_q);
  a.rnd = static_cast<const int32_t*>(rnd);
  a.qs = static_cast<int32_t*>(qs);
  a.hit = static_cast<int32_t*>(hit);
  a.ok_q = static_cast<uint8_t*>(ok_q);
  a.ok_r = static_cast<uint8_t*>(ok_r);
  a.ig = static_cast<int32_t*>(ig);
  a.chunk = static_cast<int32_t*>(chunk);
  a.idxu = static_cast<int32_t*>(idxu);
  a.P = P;
  a.S = S;
  a.Hp = Hp;
  a.T = T;
  a.R = R;
  a.Q = Q;
  a.C = C;
  a.max_q = max_q;
  a.dpp = dpp;
  if (R <= 0 || T <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch_claim_pass<true>(a, stream);
}
