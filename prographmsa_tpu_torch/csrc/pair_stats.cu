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
// out (cb * cb a pair, 16 bits where L < 2^16, as the JAX program fetches
// them); the work on the rows is small beside that once it is done a word
// of 32 columns at a time and only on the columns that can count.
//
// Design, two launches.  pgm_pair_pack turns each row once into bit planes
// of W = ceil(L / 32) words: G (gapped; padding columns >= L are gapped,
// so transparent to both statistics, as the JAX program pads with all-gap
// columns), K (counted: not gapped and the value in [0, cb), compared
// unsigned, so K is not ~G) and C (the value where K is set, else 0, one
// byte a column).  pgm_pair_stats keeps a warp a pair; each lane owns a
// contiguous run of ceil(W / 32) words.  Gap openings, a word at a time for
// each side S (X: gapped in row i only, Y: in row j only), T = Gi & Gj:
//   a = ((S << 1) | cin) & T       the first transparent column after an S
//   E = S | (T & ~(T + a))         S's state carried through those runs
//   opens += popc(S & ~((E << 1) | cin)),   cout = E >> 31
// Each lane runs its words with cin = 0, noting whether its run has a
// non-transparent column and whether the first such column is X or Y.  A
// lane's real carry in is the carry out of the nearest lower lane whose
// run is not all transparent (ballots and __clz); it changes only whether
// that first column opens a gap, which corrects the count.  Counts: for
// each set bit of Ki & Kj (__ffs, clear the lowest) one shared-memory
// atomic add into the warp's histogram (exact in any order), so the work
// grows with the counted columns and not with L.  Each of these was slower
// on the H100 at fam500 (PERF.md): a lane's words loaded four at a time
// with their counted columns' bytes four at a time (48 registers against
// 32, fewer warps resident), the histogram zeroed and written 16 bytes at
// a time (40 registers), and 4 or 2 pairs a block instead of 8.

#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;

// One warp a word of a row: lane b takes column 32 q + b.
__global__ void __launch_bounds__(256)
    pair_pack_kernel(const int* __restrict__ vals,
                     const uint8_t* __restrict__ gapm, int N, int L, int W,
                     int cb, unsigned* __restrict__ G, unsigned* __restrict__ K,
                     uint8_t* __restrict__ C) {
  const int lane = threadIdx.x & 31;
  const long gw = (long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (gw >= (long)N * W) return;
  const int row = (int)(gw / W), q = (int)(gw % W);
  const int c = q * 32 + lane;
  bool g = true;
  int v = 0;
  if (c < L) {
    const size_t at = (size_t)row * L + c;
    g = gapm[at] != 0;
    v = vals[at];
  }
  const bool k = !g && (unsigned)v < (unsigned)cb;
  const unsigned gb = __ballot_sync(kFull, g), kb = __ballot_sync(kFull, k);
  C[(size_t)row * 32 * W + c] = k ? (uint8_t)v : 0;
  if (lane == 0) {
    G[gw] = gb;
    K[gw] = kb;
  }
}

// One side's gap openings over a word; returns the carry out.
__device__ __forceinline__ unsigned side_opens(unsigned s, unsigned t,
                                               unsigned cin, int& opens) {
  const unsigned a = ((s << 1) | cin) & t;
  const unsigned e = s | (t & ~(t + a));
  opens += __popc(s & ~((e << 1) | cin));
  return e >> 31;
}

template <typename OutT>
__global__ void __launch_bounds__(256)
    pair_stats_kernel(const unsigned* __restrict__ G,
                      const unsigned* __restrict__ K,
                      const uint8_t* __restrict__ C, const int* __restrict__ pi,
                      const int* __restrict__ pj, int P, int W, int cb,
                      OutT* __restrict__ counts, int* __restrict__ gaps) {
  extern __shared__ int hist_all[];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int p = blockIdx.x * (blockDim.x >> 5) + w;
  if (p >= P) return;
  int* hist = hist_all + w * cb * cb;
  for (int k = lane; k < cb * cb; k += 32) hist[k] = 0;
  __syncwarp();

  const size_t i = pi[p], j = pj[p];
  const unsigned *Gi = G + i * W, *Gj = G + j * W;
  const unsigned *Ki = K + i * W, *Kj = K + j * W;
  const uint8_t *Ci = C + i * 32 * W, *Cj = C + j * 32 * W;
  const int run = (W + 31) >> 5;
  const int q0 = lane * run, q1 = min(q0 + run, W);
  unsigned cx = 0, cy = 0, fx = 0, fy = 0;
  bool seen = false;
  int opens = 0;
  for (int q = q0; q < q1; ++q) {
    const unsigned gi = Gi[q], gj = Gj[q];
    const unsigned t = gi & gj, x = gi & ~gj, y = gj & ~gi;
    cx = side_opens(x, t, cx, opens);
    cy = side_opens(y, t, cy, opens);
    const unsigned nt = ~t, low = nt & (0u - nt);
    if (!seen) {
      fx = x & low;
      fy = y & low;
      seen = nt != 0;
    }
    for (unsigned m = Ki[q] & Kj[q]; m; m &= m - 1) {
      const int c = q * 32 + __ffs(m) - 1;
      atomicAdd(&hist[Ci[c] * cb + Cj[c]], 1);
    }
  }
  // The carry into this lane: the carry out of the nearest lower lane with
  // a non-transparent column (a carry out computed from cin = 0 is real
  // there); none counts as not gapped.
  const unsigned live = __ballot_sync(kFull, seen);
  const unsigned bx = __ballot_sync(kFull, cx != 0);
  const unsigned by = __ballot_sync(kFull, cy != 0);
  const unsigned below = live & ((1u << lane) - 1u);
  if (below) {
    const int s = 31 - __clz(below);
    opens -= (int)(((bx >> s) & 1u) && fx) + (int)(((by >> s) & 1u) && fy);
  }
  opens = __reduce_add_sync(kFull, opens);
  __syncwarp();
  OutT* out = counts + (size_t)p * cb * cb;
  for (int k = lane; k < cb * cb; k += 32) out[k] = (OutT)hist[k];
  if (lane == 0) gaps[p] = opens;
}

}  // namespace

// vals [N, L] int32, gapm [N, L] uint8 -> G, K [N, W] uint32 bit planes
// and C [N, 32 W] uint8, W = ceil(L / 32); 1 <= cb <= 255.
extern "C" int pgm_pair_pack(const int* vals, const uint8_t* gapm, int N,
                             int L, int cb, unsigned* G, unsigned* K,
                             uint8_t* C, void* stream) {
  const int W = (L + 31) / 32;
  if (N < 1 || W < 1 || cb < 1 || cb > 255) return (int)cudaErrorInvalidValue;
  const long warps = (long)N * W;
  pair_pack_kernel<<<(unsigned)((warps + 7) / 8), 256, 0,
                     (cudaStream_t)stream>>>(vals, gapm, N, L, W, cb, G, K, C);
  return (int)cudaGetLastError();
}

// G, K [N, W], C [N, 32 W] from pgm_pair_pack; pi, pj [P] int32 row
// indices; out counts [P, cb, cb] (uint16 when `wide` is 0, which holds
// any alignment shorter than 2^16 columns, else int32), gaps [P] int32.
// `warps` pairs per block.
extern "C" int pgm_pair_stats(const unsigned* G, const unsigned* K,
                              const uint8_t* C, const int* pi, const int* pj,
                              int P, int W, int cb, int warps, int wide,
                              void* counts, int* gaps, void* stream) {
  if (P < 1 || W < 0 || cb < 1 || cb > 255 || warps < 1 || warps > 8)
    return (int)cudaErrorInvalidValue;
  const int smem = 4 * warps * cb * cb;
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const int blocks = (P + warps - 1) / warps;
  cudaStream_t s = (cudaStream_t)stream;
  if (wide)
    pair_stats_kernel<int><<<blocks, 32 * warps, smem, s>>>(
        G, K, C, pi, pj, P, W, cb, (int*)counts, gaps);
  else
    pair_stats_kernel<uint16_t><<<blocks, 32 * warps, smem, s>>>(
        G, K, C, pi, pj, P, W, cb, (uint16_t*)counts, gaps);
  return (int)cudaGetLastError();
}
