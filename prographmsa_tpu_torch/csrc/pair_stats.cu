// Kernel D1: the statistics of every listed pair of rows of a multiple
// alignment, for the prealigned distances of each re-tree.
//
// Replaces prographmsa_tpu/distances/prealigned_device.py (_make_kernel.
// kernel: the counts as a masked one-hot einsum, the gap openings as a
// lax.scan over columns, on [P, L] rows that jnp.take gathered).  For pair
// p of rows i = pi[p], j = pj[p]:
//   counts[p, a, b]  columns where row i holds value a and row j value b,
//                    neither gapped, both values in [0, cb);
//   gaps[p]          gap openings: among the columns that are not gapped in
//                    both rows (those are transparent), a column gapped on
//                    one side opens a gap when the last such column before
//                    it was not gapped on that side (none counts as not).
// Bit-identical to that program and to prealigned._pair_stats_batch_host.
//
// What bounds it on the H100: at fam500's 124,750 pairs the counts written
// out (cb * cb int32 a pair) against an alignment that stays in L2; per
// pair-column a handful of integer operations.  Design: one warp per pair,
// reading its two rows itself, 32 columns a step, neighbouring lanes on
// neighbouring columns.  Counts go to a histogram in the warp's shared
// memory by integer atomics (exact in any order).  The gap scan is carried
// 32 columns at a time: three ballots give the step's transparent columns
// and gap sides, each lane finds the last non-transparent column before its
// own among the lower lanes (or the carry from the step before), and the
// openings are counted by popcount.

#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(256)
    pair_stats_kernel(const int* __restrict__ vals,
                      const uint8_t* __restrict__ gapm,
                      const int* __restrict__ pi, const int* __restrict__ pj,
                      int P, int L, int cb, int* __restrict__ counts,
                      int* __restrict__ gaps) {
  extern __shared__ int hist_all[];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int p = blockIdx.x * (blockDim.x >> 5) + w;
  if (p >= P) return;
  int* hist = hist_all + w * cb * cb;
  for (int k = lane; k < cb * cb; k += 32) hist[k] = 0;
  __syncwarp();

  const size_t ri = (size_t)pi[p] * L, rj = (size_t)pj[p] * L;
  const unsigned below = (1u << lane) - 1u;
  bool last1 = false, last2 = false;
  int opens = 0;
  for (int c0 = 0; c0 < L; c0 += 32) {
    const int c = c0 + lane;
    bool g1 = true, g2 = true;
    if (c < L) {
      g1 = gapm[ri + c] != 0;
      g2 = gapm[rj + c] != 0;
      if (!g1 && !g2) {
        const int a = vals[ri + c], b = vals[rj + c];
        if ((unsigned)a < (unsigned)cb && (unsigned)b < (unsigned)cb)
          atomicAdd(&hist[a * cb + b], 1);
      }
    }
    const bool nt = !(g1 && g2);
    const unsigned mnt = __ballot_sync(kFull, nt);
    const unsigned m1 = __ballot_sync(kFull, nt && g1);
    const unsigned m2 = __ballot_sync(kFull, nt && g2);
    bool p1 = last1, p2 = last2;
    const unsigned before = mnt & below;
    if (before) {
      const int j = 31 - __clz(before);
      p1 = (m1 >> j) & 1u;
      p2 = (m2 >> j) & 1u;
    }
    opens += __popc(__ballot_sync(kFull, nt && g1 && !p1)) +
             __popc(__ballot_sync(kFull, nt && g2 && !p2));
    if (mnt) {
      const int j = 31 - __clz(mnt);
      last1 = (m1 >> j) & 1u;
      last2 = (m2 >> j) & 1u;
    }
  }
  __syncwarp();
  int* out = counts + (size_t)p * cb * cb;
  for (int k = lane; k < cb * cb; k += 32) out[k] = hist[k];
  if (lane == 0) gaps[p] = opens;
}

}  // namespace

// vals [N, L] int32, gapm [N, L] uint8, pi, pj [P] int32 row indices;
// out counts [P, cb, cb], gaps [P] int32.  `warps` pairs per block.
extern "C" int pgm_pair_stats(const int* vals, const uint8_t* gapm,
                              const int* pi, const int* pj, int P, int L,
                              int cb, int warps, int* counts, int* gaps,
                              void* stream) {
  if (P < 1 || cb < 1 || warps < 1 || warps > 8)
    return (int)cudaErrorInvalidValue;
  const int smem = 4 * warps * cb * cb;
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  pair_stats_kernel<<<(P + warps - 1) / warps, 32 * warps, smem,
                      (cudaStream_t)stream>>>(vals, gapm, pi, pj, P, L, cb,
                                              counts, gaps);
  return (int)cudaGetLastError();
}
