// K7d: the Phase-C parity refresh as a row copy with scattered overrides,
// for sm_90a.
//
// Replaces the Pallas kernel `_refresh_kernel` (pacmann_tpu/ops/attic.py,
// reached through refresh_parity): out = ppar with out[p, hit[q, p]] =
// new_par[q, p] wherever ok[q, p]; ppar (P, Hp, Ep), new_par (Q, P, Ep),
// hit (Q, P) int32, ok (Q, P) bool. The hit slots are unique per partition
// by the claim invariant; where one repeats, the last ok round wins, as in
// the TPU kernel's in-order round loop. A hit outside [0, Hp) writes
// nothing, as there.
//
// The TPU kernel streams each partition's parity block through VMEM and
// walks the Q rounds as a scalar loop per block. Here a CTA owns kRows rows
// of one partition: it first resolves, in shared memory, which round (if
// any) owns each of its rows (atomicMax over the round index, so the last
// ok round wins whatever order the threads run in, and no two rounds race
// on a row), then writes each of its rows once, from new_par where a round
// owns it, else from ppar. The caller's ppar is never written.
//
// Bound on the H100: device memory. The function reads every row of ppar
// that is not replaced, the replacing rows of new_par, the (Q, P) hits, and
// writes the whole (P, Hp, Ep) output: at P = 16, Hp = 3584, Ep = 256 about
// 2 x 58.7 MB. Rows move as uint4, a warp's 32 lanes on 512 contiguous
// bytes.

#include <cstdint>
#include <cuda_runtime.h>

constexpr int kThreads = 256;
constexpr int kRows = 32;        // parity rows per CTA

__global__ void __launch_bounds__(kThreads) refresh_kernel(
    const uint4* __restrict__ ppar, const uint4* __restrict__ new_par,
    const int32_t* __restrict__ hit, const uint8_t* __restrict__ ok,
    uint4* __restrict__ out, int P, int Hp, int Q, int ep4) {
  __shared__ int owner[kRows];
  const int p = blockIdx.y;
  const int h0 = blockIdx.x * kRows;
  if (threadIdx.x < kRows) owner[threadIdx.x] = -1;
  __syncthreads();
  for (int q = threadIdx.x; q < Q; q += kThreads) {
    const size_t qp = static_cast<size_t>(q) * P + p;
    const int h = hit[qp];
    if (ok[qp] && h >= h0 && h < h0 + kRows && h < Hp) {
      atomicMax(&owner[h - h0], q);
    }
  }
  __syncthreads();
  const int rows = min(kRows, Hp - h0);
  const size_t first = (static_cast<size_t>(p) * Hp + h0) * ep4;
  for (int i = threadIdx.x; i < rows * ep4; i += kThreads) {
    const int r = i / ep4;
    const int c = i - r * ep4;
    const int q = owner[r];
    const uint4* src =
        q >= 0 ? new_par + (static_cast<size_t>(q) * P + p) * ep4
               : ppar + first + static_cast<size_t>(r) * ep4;
    out[first + i] = __ldg(src + c);
  }
}

// ppar (P, Hp, Ep) int32, new_par (Q, P, Ep) int32, hit (Q, P) int32,
// ok (Q, P) bool -> out (P, Hp, Ep) int32. Device buffers, contiguous,
// 16-byte aligned, Ep a multiple of 4. Returns the launch's cudaError_t
// (0 on success); Ep not a multiple of 4 or more than 65,535 partitions is
// refused with cudaErrorInvalidValue.
extern "C" int refresh_parity(const void* ppar, const void* new_par,
                              const void* hit, const void* ok, void* out,
                              int P, int Hp, int Ep, int Q, void* stream) {
  if (Ep % 4 != 0 || P > 65535 || Hp < 0 || Q < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (P <= 0 || Hp == 0 || Ep == 0) return 0;
  const dim3 grid((Hp + kRows - 1) / kRows, P);
  refresh_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(ppar), static_cast<const uint4*>(new_par),
      static_cast<const int32_t*>(hit), static_cast<const uint8_t*>(ok),
      static_cast<uint4*>(out), P, Hp, Q, Ep / 4);
  return static_cast<int>(cudaGetLastError());
}
