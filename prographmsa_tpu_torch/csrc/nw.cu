// Kernel D2: all-pairs Needleman-Wunsch with affine gaps, fill and
// backtrack, for a batch of sequence pairs.
//
// Replaces prographmsa_tpu/distances/nw_device.py (_make_kernel.kernel: an
// anti-diagonal lax.scan fill in int32 over [B, L2 + 1] rows, then a masked
// batched backtrack scan).  Output per pair: counts[s1, s2] of the aligned
// residue pairs whose codes are both < dim, and the number of gap openings:
// bit-identical to that program and to the host's native.nw_counts_native.
//
// Recurrence (row y from sequence 2, column x from sequence 1):
//   X(y,x) = max(X(y,x-1) + ge, W(y,x-1) + go)
//   Y(y,x) = max(Y(y-1,x) + ge, W(y-1,x) + go)
//   W(y,x) = max(W(y-1,x-1) + scoring[s2[y-1], s1[x-1]], max(X, Y))
// with W(0,0) = 0, W(0,x) = X(0,x) = go + (x-1) ge, Y(0,x) = MINFTY, and the
// same with y and x swapped.  The backtrack from (l2, l1) takes the diagonal
// when W == W(y-1,x-1) + score, else X when W == X, else Y; it stops at the
// first row or column.
//
// What bounds it on the H100: issue slots.  A cell is a chain of integer
// maxima and sums, and the card issues 4 warp-instructions a clock per SM;
// every instruction a cell spends beyond its few sums and maxima costs
// directly.  Design: one warp per pair, filling strips of 32 R rows (R = 1,
// 2 or 4, a template parameter) in a wavefront over x.  At step s lane l
// takes column x = s - l for its R rows, top to bottom, all in registers:
// the first row gets W and Y of the row above from lane l - 1 (one shuffle
// each; lane 0 from the row buffer in shared memory, where lane 31 of the
// strip above left them), the other R - 1 from the row before in registers,
// so a shuffle pair and the step's bookkeeping serve R cells.  A pair's
// last strip, where at most 16 R rows are left, takes 64 or 32 rows (2 or 1
// a lane), so fewer lanes run empty.  The scores come from a profile built
// at the strip's start: per code c one word a lane, byte r the int8 score
// of the lane's row r against c, at prof[c * 32 + lane] (no bank
// conflicts); a step loads c1[x] and that word, neither on the recurrence's
// chain, and takes a byte with one PRMT.  The maxima are Hopper's DPX
// instructions:
//   Xn = __viaddmax_s32(X, ge, W + go)   (W + go kept from the step before)
//   Yn = __viaddmax_s32(upY, ge, upW + go)
//   Wn = __vibmax_s32(d, __vibmax_s32(Xn, Yn, &px), &pd)
// and their predicates are the two backtrack bits: pd <=> Wn == d, px <=> Xn
// >= Yn, which is "W == X" wherever the diagonal is not taken.  Where the
// diagonal is taken px may differ from "W == X"; the walk never reads it
// there, so counts and gaps are unchanged.  The steps run in chunks of 16:
// a chunk where every lane's x lies in 1 .. n1 (steps 32 .. n1) runs
// without a test; the 31-step ramp-in keeps a cell left of x = 1 as it was;
// the ramp-out runs the cells right of x = n1 on, clamping only its reads.
// Each lane packs a row's 16 steps into a word (bits 2j, 2j + 1 for step s0
// + j: constant positions in the unrolled chunk, each set by a select) and
// stores its R words at the chunk's end, unconditionally: a strip from row
// y0 at (y0 - 1) words of the pair's scratch, laid out [chunk][row of the
// strip] (a warp's store is 32 R consecutive words); a row is padded to L1
// + 32 cells and the rows to whole strips of 32 R, so the ramps' words have
// a place.  Then lane 0 walks the bits back from (l2, l1), finding cell (y,
// x) at step x + lane of its row, reading through L2 and keeping the word
// it is in, and counts into a histogram in shared memory.  The scoring
// table, both sequences' codes, the profile, the row buffers and the
// histogram sit in shared memory.  A fill-only variant (no walk) exists for
// timing the walk's share; only nw_sweep.py launches it.

#include "common.cuh"

namespace {

constexpr int kMinfty = -10000;
constexpr unsigned kFull = 0xffffffffu;

template <typename CodeT>
__host__ __device__ inline int code_ints(int L) {
  return (L * (int)sizeof(CodeT) + 3) / 4;
}

// ints of shared memory per warp: two row buffers of L1 + 1, the histogram,
// the score profile (T codes x 32 lanes), both sequences' codes
template <typename CodeT>
__host__ __device__ inline int warp_ints(int T, int L1, int L2, int dim) {
  return 2 * (L1 + 1) + dim * dim + 32 * T + code_ints<CodeT>(L1) +
         code_ints<CodeT>(L2);
}

// words of backtrack bits a row: steps 0 .. L1 + 31, 16 a word
__host__ __device__ inline int row_words(int L1) { return (L1 + 47) / 16; }

// byte r of p, sign-extended: one PRMT (selector nibble r copies the byte,
// 8 | r replicates its sign)
__device__ __forceinline__ int sbyte(uint32_t p, int r) {
  int v;
  asm("prmt.b32 %0, %1, 0, %2;"
      : "=r"(v)
      : "r"(p), "r"(r | (8 | r) << 4 | (8 | r) << 8 | (8 | r) << 12));
  return v;
}

// the registers of a lane's R rows: W, W + go, X, Y of the last cell
// filled, and the chunk's bit words
template <int R>
struct Rows {
  int W[R], Wgo[R], X[R], Y[R];
  uint32_t acc[R];
};

// What a chunk of steps may meet: kSteady, every lane's x in 1 .. n1 (no
// test, no clamp); kRampIn (steps 0 .. 31), x < 1 too, where the registers
// must keep the cells (y, 0); kRampOut (steps from 32 on), x > n1 too,
// which runs on unchecked (a lane there feeds only lanes there) with its
// reads clamped and no row buffer store.
constexpr int kSteady = 0, kRampIn = 1, kRampOut = 2;

// One step of a lane: column x for its R rows, bits at positions 2j, 2j+1.
template <int R, int MODE, typename CodeT>
__device__ __forceinline__ void nw_step(Rows<R>& v, int& dg0, int x, int j,
                                        int lane, int n1, int go, int ge,
                                        const CodeT* c1,
                                        const uint32_t* profl, int* rowW,
                                        int* rowY) {
  // lane - 1's last row, the step before: cell (y - 1, x)
  const int shW = __shfl_up_sync(kFull, v.W[R - 1], 1);
  const int shY = __shfl_up_sync(kFull, v.Y[R - 1], 1);
  const int xb = MODE == kSteady ? x : min(max(x, 0), n1);
  const int upW0 = lane == 0 ? rowW[xb] : shW;
  int upY = lane == 0 ? rowY[xb] : shY;
  const int ci = c1[MODE == kSteady ? x - 1 : min(max(x - 1, 0), n1 - 1)];
  const uint32_t prow = profl[ci * 32];
  const bool live = MODE != kRampIn || (x >= 1 && x <= n1);
  const bool inr = MODE == kSteady || (x >= 0 && x <= n1);
  // the first row's diagonal is the row above one step back
  int dg = dg0;
  dg0 = MODE != kRampIn || inr ? upW0 : dg0;
  int upWgo = upW0 + go;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int d = dg + sbyte(prow, r);
    const int Xn = __viaddmax_s32(v.X[r], ge, v.Wgo[r]);
    const int Yn = __viaddmax_s32(upY, ge, upWgo);
    bool px, pd;
    const int m = __vibmax_s32(Xn, Yn, &px);
    const int Wn = __vibmax_s32(d, m, &pd);
    v.acc[r] |= (pd ? 1u << (2 * j) : 0u) | (px ? 2u << (2 * j) : 0u);
    dg = v.W[r];
    const int Wgon = Wn + go;
    if (MODE != kRampIn) {
      v.W[r] = Wn;
      v.Wgo[r] = Wgon;
      v.X[r] = Xn;
      v.Y[r] = Yn;
    } else {
      v.W[r] = live ? Wn : v.W[r];
      v.Wgo[r] = live ? Wgon : v.Wgo[r];
      v.X[r] = live ? Xn : v.X[r];
      v.Y[r] = live ? Yn : v.Y[r];
    }
    upY = Yn;
    upWgo = Wgon;
  }
  // the strip's last row for the strip below (x = 0 included: W(y, 0))
  if (lane == 31 && inr) {
    rowW[x] = v.W[R - 1];
    rowY[x] = v.Y[R - 1];
  }
}

// Steps s0 .. s0 + 15 (x = s - lane), then the lane's R words to `out`.
template <int R, int MODE, typename CodeT>
__device__ __forceinline__ void nw_chunk(Rows<R>& v, int& dg0, int s0,
                                         int lane, int n1, int go, int ge,
                                         const CodeT* c1,
                                         const uint32_t* profl, int* rowW,
                                         int* rowY, uint32_t* out) {
#pragma unroll
  for (int r = 0; r < R; ++r) v.acc[r] = 0;
#pragma unroll
  for (int j = 0; j < 16; ++j)
    nw_step<R, MODE, CodeT>(v, dg0, s0 + j - lane, j, lane, n1, go, ge, c1,
                              profl, rowW, rowY);
  if constexpr (R == 4) {
    *reinterpret_cast<uint4*>(out) =
        make_uint4(v.acc[0], v.acc[1], v.acc[2], v.acc[3]);
  } else if constexpr (R == 2) {
    *reinterpret_cast<uint2*>(out) = make_uint2(v.acc[0], v.acc[1]);
  } else {
    *out = v.acc[0];
  }
}

// One strip of 32 RS rows from row y0: the lane's column of the profile
// (only this lane reads it), its registers, the chunks of steps 0 .. n1 +
// 31 (n1 >= 1); its bits at pb + (y0 - 1) words, [chunk][row of the strip].
template <int RS, typename CodeT>
__device__ __forceinline__ void nw_strip(int y0, int lane, int n1, int n2,
                                         int T, int go, int ge, int words,
                                         const int* table, const CodeT* c1,
                                         const CodeT* c2, uint32_t* prof,
                                         int* rowW, int* rowY,
                                         uint32_t* pb) {
  constexpr int S = 32 * RS;
  const int ya = y0 + lane * RS;  // the lane's first row
  for (int c = 0; c < T; ++c) {
    uint32_t pk = 0;
#pragma unroll
    for (int r = 0; r < RS; ++r) {
      const int sc = ya + r <= n2 ? table[(int)c2[ya + r - 1] * T + c] : 0;
      pk |= ((uint32_t)sc & 0xffu) << (8 * r);
    }
    prof[c * 32 + lane] = pk;
  }
  // registers start as the cells (y, 0): W = Y = go + (y-1) ge
  Rows<RS> v;
#pragma unroll
  for (int r = 0; r < RS; ++r) {
    v.W[r] = go + (ya + r - 1) * ge;
    v.Wgo[r] = v.W[r] + go;
    v.X[r] = kMinfty;
    v.Y[r] = v.W[r];
  }
  int dg0 = 0;
  uint32_t* out = pb + (size_t)(y0 - 1) * words + lane * RS;
  const uint32_t* profl = prof + lane;
  const int nch = (n1 + 31) / 16 + 1;
  int k = 0;
  for (; k < 2 && k < nch; ++k)
    nw_chunk<RS, kRampIn, CodeT>(v, dg0, 16 * k, lane, n1, go, ge, c1, profl,
                                 rowW, rowY, out + k * S);
  for (; 16 * k + 15 <= n1; ++k)
    nw_chunk<RS, kSteady, CodeT>(v, dg0, 16 * k, lane, n1, go, ge, c1, profl,
                                 rowW, rowY, out + k * S);
  for (; k < nch; ++k)
    nw_chunk<RS, kRampOut, CodeT>(v, dg0, 16 * k, lane, n1, go, ge, c1,
                                  profl, rowW, rowY, out + k * S);
  __syncwarp();
}

template <typename CodeT, int R, bool WALK>
__global__ void __launch_bounds__(256)
    nw_kernel(const CodeT* __restrict__ s1b, const CodeT* __restrict__ s2b,
              const int* __restrict__ l1, const int* __restrict__ l2,
              const int* __restrict__ scoring, int T, int go, int ge, int dim,
              int B, int L1, int L2, uint32_t* bits,
              int* __restrict__ counts, int* __restrict__ gaps) {
  constexpr int S = 32 * R;  // rows a strip
  extern __shared__ int smem[];
  const int warps = blockDim.x >> 5;
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  int* table = smem;
  for (int i = threadIdx.x; i < T * T; i += blockDim.x) table[i] = scoring[i];
  __syncthreads();
  const int p = blockIdx.x * warps + w;
  if (p >= B) return;

  int* rowW = smem + T * T + w * warp_ints<CodeT>(T, L1, L2, dim);
  int* rowY = rowW + L1 + 1;
  int* hist = rowY + L1 + 1;
  uint32_t* prof = reinterpret_cast<uint32_t*>(hist + dim * dim);
  CodeT* c1 = reinterpret_cast<CodeT*>(hist + dim * dim + 32 * T);
  CodeT* c2 = reinterpret_cast<CodeT*>(hist + dim * dim + 32 * T +
                                       code_ints<CodeT>(L1));
  const int n1 = l1[p], n2 = l2[p];
  for (int i = lane; i < n1; i += 32) c1[i] = s1b[(size_t)p * L1 + i];
  for (int i = lane; i < n2; i += 32) c2[i] = s2b[(size_t)p * L2 + i];
  for (int i = lane; i < dim * dim; i += 32) hist[i] = 0;
  for (int x = lane; x <= n1; x += 32) {
    rowW[x] = x == 0 ? 0 : go + (x - 1) * ge;
    rowY[x] = kMinfty;
  }
  __syncwarp();

  // this pair's bits: a strip from row y0 at (y0 - 1) words.  Strips of
  // 32 R rows while more than 16 R rows are left, then one of 64 (R = 4)
  // or 32 rows for the rest: the rows stay within whole strips of 32 R.
  const int words = row_words(L1);
  uint32_t* pb = bits + (size_t)p * ((L2 + S - 1) / S) * S * words;
  for (int y0 = 1; n1 > 0 && y0 <= n2;) {
    const int left = n2 - y0 + 1;
    if constexpr (R >= 4) {
      if (left > 64) {
        nw_strip<4, CodeT>(y0, lane, n1, n2, T, go, ge, words, table, c1,
                           c2, prof, rowW, rowY, pb);
        y0 += 128;
        continue;
      }
    }
    if constexpr (R >= 2) {
      if (left > 32) {
        nw_strip<2, CodeT>(y0, lane, n1, n2, T, go, ge, words, table, c1,
                           c2, prof, rowW, rowY, pb);
        y0 += 64;
        continue;
      }
    }
    nw_strip<1, CodeT>(y0, lane, n1, n2, T, go, ge, words, table, c1, c2,
                       prof, rowW, rowY, pb);
    y0 += 32;
  }

  if (WALK && lane == 0) {
    // rows 1 .. tb lie in strips of 32 R rows, the rest in one of 32 << tsh
    const int tb = n2 > S / 2 ? (n2 - S / 2 + S - 1) / S * S : 0;
    const int tsh = R >= 4 && n2 - tb > 32 ? 1 : 0;
    int y = n2, x = n1, ng = 0;
    bool go1 = false, go2 = false;
    long long cur = -1;
    uint32_t word = 0;
    while (y > 0 && x > 0) {
      const int ry = y - 1;
      const bool full = ry < tb;
      const int base = full ? ry & ~(S - 1) : tb;
      const int i = ry - base;  // row of the strip: lane i / (rows a lane)
      const int s = x + (full ? i / R : i >> tsh);
      const long long wi = (long long)base * words +
                           (s >> 4) * (full ? S : 32 << tsh) + i;
      if (wi != cur) {
        word = __ldcg(pb + wi);
        cur = wi;
      }
      const uint32_t b = (word >> (2 * (s & 15))) & 3u;
      if (b & 1u) {
        const int a = c1[x - 1], c = c2[y - 1];
        if (a < dim && c < dim) hist[a * dim + c] += 1;
        go1 = go2 = false;
        --x;
        --y;
      } else if (b & 2u) {
        ng += !go1;
        go1 = true;
        go2 = false;
        --x;
      } else {
        ng += !go2;
        go2 = true;
        go1 = false;
        --y;
      }
    }
    gaps[p] = ng;
  } else if (!WALK && lane == 0) {
    gaps[p] = 0;
  }
  __syncwarp();
  int* cp = counts + (size_t)p * dim * dim;
  for (int i = lane; i < dim * dim; i += 32) cp[i] = hist[i];
}

template <typename CodeT, int R, bool WALK>
int launch_nw(const void* s1b, const void* s2b, const int* l1, const int* l2,
              const int* scoring, int T, int go, int ge, int dim, int B,
              int L1, int L2, int warps, int smem_bytes, uint32_t* bits,
              int* counts, int* gaps, cudaStream_t stream) {
  const int need = 4 * (T * T + warps * warp_ints<CodeT>(T, L1, L2, dim));
  if (B < 1 || warps < 1 || warps > 8 || smem_bytes < need)
    return (int)cudaErrorInvalidValue;
  auto kern = nw_kernel<CodeT, R, WALK>;
  if (smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<(B + warps - 1) / warps, 32 * warps, smem_bytes, stream>>>(
      static_cast<const CodeT*>(s1b), static_cast<const CodeT*>(s2b), l1, l2,
      scoring, T, go, ge, dim, B, L1, L2, bits, counts, gaps);
  return (int)cudaGetLastError();
}

template <typename CodeT, int R>
int launch_nw_walk(bool walk, const void* s1b, const void* s2b,
                   const int* l1, const int* l2, const int* scoring, int T,
                   int go, int ge, int dim, int B, int L1, int L2, int warps,
                   int smem_bytes, uint32_t* bits, int* counts, int* gaps,
                   cudaStream_t st) {
  if (walk)
    return launch_nw<CodeT, R, true>(s1b, s2b, l1, l2, scoring, T, go, ge,
                                     dim, B, L1, L2, warps, smem_bytes, bits,
                                     counts, gaps, st);
  return launch_nw<CodeT, R, false>(s1b, s2b, l1, l2, scoring, T, go, ge, dim,
                                    B, L1, L2, warps, smem_bytes, bits, counts,
                                    gaps, st);
}

template <typename CodeT>
int launch_nw_rows(int rows, bool walk, const void* s1b, const void* s2b,
                   const int* l1, const int* l2, const int* scoring, int T,
                   int go, int ge, int dim, int B, int L1, int L2, int warps,
                   int smem_bytes, uint32_t* bits, int* counts, int* gaps,
                   cudaStream_t st) {
  switch (rows) {
    case 1:
      return launch_nw_walk<CodeT, 1>(walk, s1b, s2b, l1, l2, scoring, T, go,
                                      ge, dim, B, L1, L2, warps, smem_bytes,
                                      bits, counts, gaps, st);
    case 2:
      return launch_nw_walk<CodeT, 2>(walk, s1b, s2b, l1, l2, scoring, T, go,
                                      ge, dim, B, L1, L2, warps, smem_bytes,
                                      bits, counts, gaps, st);
    case 4:
      return launch_nw_walk<CodeT, 4>(walk, s1b, s2b, l1, l2, scoring, T, go,
                                      ge, dim, B, L1, L2, warps, smem_bytes,
                                      bits, counts, gaps, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// `iters` rounds of 8 independent DPX instructions a thread, summed into
// `sink` so that none is dead: the rate chip_smoke.py states D2's bound with.
// mode 0: __viaddmax_s32; mode 1: __vibmax_s32 (the predicates of all but
// the last round are dead, so those rounds may compile to the same
// instruction without its predicate output).
template <int MODE>
__global__ void dpx_rate_kernel(int iters, int a0, int b0, int* sink) {
  int a[8];
  bool pr[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    a[j] = a0 + (int)threadIdx.x + 7 * j;
    pr[j] = false;
  }
  const int c = b0 * 3 + (int)threadIdx.x;
#pragma unroll 4
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (MODE == 0)
        a[j] = __viaddmax_s32(a[j], b0, c + j);
      else
        a[j] = __vibmax_s32(a[j], a[(j + 1) & 7], &pr[j]);
    }
  }
  int t = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) t += a[j] + (int)pr[j];
  if (t == 0x7fffffff) *sink = t;
}

}  // namespace

// s1b [B, L1], s2b [B, L2] codes of `code_bytes` (1: uint8, 4: int32),
// l1, l2 [B], scoring [T, T] int32 with every entry in -128 .. 127; `rows`
// (1, 2, 4) rows a lane; `walk` 0 only for the fill-only variant; `bits`
// scratch of B * ceil(L2 / (32 rows)) * 32 rows * ((L1 + 47) / 16) words;
// out counts [B, dim, dim], gaps [B] int32.
extern "C" int pgm_nw(const void* s1b, const void* s2b, const int* l1,
                      const int* l2, const int* scoring, int T, int go,
                      int ge, int dim, int B, int L1, int L2, int code_bytes,
                      int rows, int warps, int walk, int smem_bytes,
                      void* bits, int* counts, int* gaps, void* stream) {
  uint32_t* b = static_cast<uint32_t*>(bits);
  cudaStream_t st = (cudaStream_t)stream;
  if (code_bytes == 1)
    return launch_nw_rows<uint8_t>(rows, walk != 0, s1b, s2b, l1, l2, scoring,
                                   T, go, ge, dim, B, L1, L2, warps,
                                   smem_bytes, b, counts, gaps, st);
  if (code_bytes == 4)
    return launch_nw_rows<int>(rows, walk != 0, s1b, s2b, l1, l2, scoring, T,
                               go, ge, dim, B, L1, L2, warps, smem_bytes, b,
                               counts, gaps, st);
  return (int)cudaErrorInvalidValue;
}

// `blocks` x 256 threads, `iters` rounds of the DPX probe of `mode`.
extern "C" int pgm_dpx_rate(int mode, int blocks, int iters, int* sink,
                            void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (blocks < 1 || iters < 1) return (int)cudaErrorInvalidValue;
  if (mode == 0)
    dpx_rate_kernel<0><<<blocks, 256, 0, st>>>(iters, 1, -2, sink);
  else if (mode == 1)
    dpx_rate_kernel<1><<<blocks, 256, 0, st>>>(iters, 1, -2, sink);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
