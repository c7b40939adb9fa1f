// K3 and K4: the PIR client's slot selection, one CTA per partition, sm_90a.
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
// The rounds of one partition are serial: each depends on what the earlier
// ones claimed. The TPU kernel walks them with a grid over partitions; here
// a CTA owns one partition and loops over the rounds. The claimed set is
// one byte per slot in shared memory, beside each slot's programmed chunk
// (-1 = unprogrammed), so a round reads only its chunk's slot-column row
// (Hp int32, 14 KB at SIFT1M shape) from global memory. The first eligible
// slot is a block min-reduction (warp __reduce_min_sync, then one word per
// warp), so no atomics decide "first". Two barriers per round.
//
// Bound on the H100: latency. At SIFT1M shape (P = 16, Q = 6 or 96) the
// work is 16 CTAs x Q rounds of one 14 KB row read (from L2 after the first
// touch) and two barriers; 16 of 132 SMs are busy. What the kernel saves is
// the host: the owner fixpoint it replaces launches hundreds of small ops
// and syncs the host once per pass. Nothing here syncs the host.

#include <cstdint>
#include <cuda_runtime.h>

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
// dynamic shared memory a CTA gets without opting in; above it each kernel
// instantiation is opted in, up to the device's limit
// cudaDevAttrMaxSharedMemoryPerBlockOptin (232,448 B on an H100): the plan
// reaches 72 KB at Hp = 14,336 (640 B entries, n of about 4.3M to 7M)
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

static size_t smem_bytes(int Hp, int S) {
  return static_cast<size_t>(Hp) * 4 + static_cast<size_t>(S) * 4 +
         kWarps * 4 + static_cast<size_t>(Hp);
}

template <bool kFull>
__global__ void __launch_bounds__(kThreads) select_kernel(const Args a) {
  extern __shared__ int32_t smem[];
  int32_t* pc = smem;                                   // (Hp) programmed chunk
  int32_t* found_c = pc + a.Hp;                         // (S) found rounds
  unsigned* red = reinterpret_cast<unsigned*>(found_c + a.S);      // (kWarps)
  uint8_t* claimed = reinterpret_cast<uint8_t*>(red + kWarps);     // (Hp)

  const int p = blockIdx.x;
  const int tid = threadIdx.x;
  const int Hp = a.Hp, S = a.S, C = a.C;
  const unsigned uC = static_cast<unsigned>(C);
  const int32_t* prog_p = a.prog + static_cast<size_t>(p) * Hp;
  for (int h = tid; h < Hp; h += kThreads) {
    const int v = prog_p[h];
    pc[h] = v != a.dpp ? static_cast<int>(static_cast<unsigned>(v) / uC) : -1;
    claimed[h] = 0;
  }
  for (int s = tid; s < S; s += kThreads) found_c[s] = 0;
  __syncthreads();

  int rankp = 0;                          // admitted rounds so far (K3)
  const int fin = kFull ? a.finished[p] : 0;
  for (int q = 0; q < a.Q; ++q) {
    const size_t qp = static_cast<size_t>(q) * a.P + p;
    int ck, off, u = 0;
    bool real;
    if (kFull) {
      const int idx = a.idx_q[qp];
      real = idx >= 0;
      u = real ? idx : 0;
      ck = u / C;
      off = u % C;
    } else {
      ck = a.chunk_q[qp];
      off = a.off_q[qp];
      real = a.real_q[qp] != 0;
    }
    // a chunk outside [0, S) is outside the contract: read nothing for it
    const bool in_range = ck >= 0 && ck < S;
    // found_c was last written before the previous round's closing barrier
    const int prev = in_range ? found_c[ck] : 0;

    unsigned m = static_cast<unsigned>(Hp);
    if (real && in_range) {
      const int32_t* col = a.slot_col + (static_cast<size_t>(p) * S + ck) * Hp;
#pragma unroll 4
      for (int h = tid; h < Hp; h += kThreads) {
        const bool elig = col[h] == off && pc[h] != ck && !claimed[h];
        m = elig ? min(m, static_cast<unsigned>(h)) : m;
      }
    }
    m = __reduce_min_sync(0xffffffffu, m);
    if ((tid & 31) == 0) red[tid >> 5] = m;
    __syncthreads();
    unsigned mh = red[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) mh = min(mh, red[w]);
    const bool fnd = real && mh < static_cast<unsigned>(Hp);
    const int h_out = fnd ? static_cast<int>(mh) : 0;

    if (!kFull) {
      if (tid == 0) {
        if (fnd) claimed[mh] = 1;
        a.hit[qp] = h_out;
        a.found[qp] = fnd;
      }
    } else {
      const int hist_own = in_range ? a.hist[static_cast<size_t>(p) * S + ck]
                                    : 0;
      const int g = hist_own + prev - (fnd ? 0 : 1);
      const bool okr = fnd && g < a.R;
      const bool okq = okr && rankp < a.max_q - fin;
      rankp += okr ? 1 : 0;
      const int gc = min(g, a.R - 1);
      if (tid == 0) {
        if (fnd) {
          claimed[mh] = 1;
          found_c[ck] += 1;
        }
        a.hit[qp] = h_out;
        a.ok_q[qp] = okq;
        a.ok_r[qp] = okr;
        a.ig[qp] = gc;
        a.chunk[qp] = ck;
        a.idxu[qp] = u;
      }
      int32_t* out = a.qs + qp * S;
      if (okq) {
        // okq implies fnd (mh < Hp, 0 <= ck < S) and g < R; a negative
        // group index (hist < 0 is outside the contract) selects 0, as the
        // TPU kernel's one-hot select over r does, and reads nothing
        const size_t slot = static_cast<size_t>(p) * Hp + mh;
        const int htag = a.tag[slot];
        const int hp = prog_p[mh];
        const int hs = hp != a.dpp
                           ? static_cast<int>(static_cast<unsigned>(hp) / uC)
                           : -1;
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
        for (int s = tid; s < S; s += kThreads) {
          int v = trow[s];
          v = s == hs ? hv : v;
          v = s == ck ? rv : v;
          out[s] = v;
        }
      } else {
        const int32_t* dummy = a.rnd + qp * S;
        for (int s = tid; s < S; s += kThreads) out[s] = dummy[s];
      }
    }
    // claimed, found_c and red are settled before the next round reads them
    __syncthreads();
  }
}

// The most dynamic shared memory one CTA may opt in to on `device`.
static int smem_optin(int device, int* bytes) {
  return static_cast<int>(cudaDeviceGetAttribute(
      bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device));
}

template <bool kFull>
static int launch_one(const Args& a, size_t smem, cudaStream_t st) {
  if (smem > kDefaultSmem) {
    // set before this instantiation's launch, or the launch is refused
    const cudaError_t err = cudaFuncSetAttribute(
        select_kernel<kFull>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  select_kernel<kFull><<<a.P, kThreads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

static int launch(const Args& a, bool full, void* stream) {
  if (a.Hp <= 0 || a.S <= 0 || a.C <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = smem_bytes(a.Hp, a.S);
  if (smem > kDefaultSmem) {
    int device = 0, limit = 0;
    int err = static_cast<int>(cudaGetDevice(&device));
    if (err == 0) err = smem_optin(device, &limit);
    if (err != 0) return err;
    if (smem > static_cast<size_t>(limit)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (a.P <= 0 || a.Q <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return full ? launch_one<true>(a, smem, st) : launch_one<false>(a, smem, st);
}

// The shared-memory limit K3 and K4 launch under on `device`, in bytes,
// into *bytes. Returns the cudaError_t of the query.
extern "C" int protocol_smem_limit(int device, int* bytes) {
  return smem_optin(device, bytes);
}

// K4. slot_col (P, S, Hp), prog (P, Hp), chunk_q/off_q (Q, P) int32,
// real_q (Q, P) bool -> hit (Q, P) int32, found (Q, P) bool. All device
// buffers, contiguous. Returns the launch's cudaError_t (0 on success);
// shapes whose plan exceeds the device's opt-in shared memory are refused
// (cudaErrorInvalidValue).
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
  return launch(a, false, stream);
}

// K3. State slot_col (P, S, Hp), prog/tag (P, Hp), table (P, T, S),
// repl_idx (P, S, R), hist (P, S), finished (P,); idx_q (Q, P), rnd
// (Q, P, S) -> qs (Q, P, S), hit/ig/chunk/idxu (Q, P) int32, ok_q/ok_r
// (Q, P) bool. All int32 unless noted, device buffers, contiguous. Returns
// the launch's cudaError_t, as claim_select does.
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
  return launch(a, true, stream);
}
