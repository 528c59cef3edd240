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
// What bounds it on the H100: a chain of dependent integer operations per
// cell (about 11 int32 operations, the card's int32 lanes are half its
// float32 lanes), and for the backtrack a walk of dependent loads.  Design:
// one warp per pair; the warp fills strips of 32 rows, a lane per row, in a
// wavefront over x: at step s lane l owns cell (y0 + l, s - l), and the
// values of the row above come from lane l - 1 by one shuffle.  The strip's
// last row goes to the next strip through a row buffer in shared memory,
// read by lane 0 at step x before lane 31 overwrites it at step x + 31.
// Per cell the fill keeps two bits for the backtrack in device memory, "W
// == W(y-1,x-1) + score" and "W == X" (a lane packs 16 cells of its row into
// a word), not the W and X planes: 2 bits, not 8 bytes, a cell.  Then lane 0
// walks the bits back from (l2, l1), keeping the word it is in, and counts
// into a histogram in shared memory.  The scoring table, both sequences'
// codes and the histogram sit in shared memory.

#include "common.cuh"

namespace {

constexpr int kMinfty = -10000;
constexpr unsigned kFull = 0xffffffffu;

template <typename CodeT>
__host__ __device__ inline int code_ints(int L) {
  return (L * (int)sizeof(CodeT) + 3) / 4;
}

// ints of shared memory per warp: two row buffers of L1 + 1, the histogram,
// both sequences' codes
template <typename CodeT>
__host__ __device__ inline int warp_ints(int L1, int L2, int dim) {
  return 2 * (L1 + 1) + dim * dim + code_ints<CodeT>(L1) +
         code_ints<CodeT>(L2);
}

template <typename CodeT>
__global__ void __launch_bounds__(256)
    nw_kernel(const CodeT* __restrict__ s1b, const CodeT* __restrict__ s2b,
              const int* __restrict__ l1, const int* __restrict__ l2,
              const int* __restrict__ scoring, int T, int go, int ge, int dim,
              int B, int L1, int L2, int words, uint32_t* bits,
              int* __restrict__ counts, int* __restrict__ gaps) {
  extern __shared__ int smem[];
  const int warps = blockDim.x >> 5;
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  int* table = smem;
  for (int i = threadIdx.x; i < T * T; i += blockDim.x) table[i] = scoring[i];
  __syncthreads();
  const int p = blockIdx.x * warps + w;
  if (p >= B) return;

  int* rowW = smem + T * T + w * warp_ints<CodeT>(L1, L2, dim);
  int* rowY = rowW + L1 + 1;
  int* hist = rowY + L1 + 1;
  CodeT* c1 = reinterpret_cast<CodeT*>(hist + dim * dim);
  CodeT* c2 = reinterpret_cast<CodeT*>(hist + dim * dim + code_ints<CodeT>(L1));
  const int n1 = l1[p], n2 = l2[p];
  for (int i = lane; i < n1; i += 32) c1[i] = s1b[(size_t)p * L1 + i];
  for (int i = lane; i < n2; i += 32) c2[i] = s2b[(size_t)p * L2 + i];
  for (int i = lane; i < dim * dim; i += 32) hist[i] = 0;
  for (int x = lane; x <= n1; x += 32) {
    rowW[x] = x == 0 ? 0 : go + (x - 1) * ge;
    rowY[x] = kMinfty;
  }
  __syncwarp();

  // bit plane of this pair: row y - 1, word (x - 1) / 16, bits 2k and 2k + 1
  uint32_t* pb = bits + (size_t)p * L2 * words;
  for (int y0 = 1; y0 <= n2; y0 += 32) {
    const int y = y0 + lane;
    const bool row = y <= n2;
    const int* trow = table + (row ? (int)c2[y - 1] : 0) * T;
    uint32_t* brow = pb + (size_t)(row ? y - 1 : 0) * words;
    // the lane's cell of the step before, from (y, 0): W = Y = go + (y-1) ge
    int W = go + (y - 1) * ge, X = kMinfty, Y = W;
    // W(y - 1, 0): lane 0's diagonal at x = 1 (the other lanes take theirs
    // from lane - 1 at x = 0)
    int diagW = y == 1 ? 0 : go + (y - 2) * ge;
    uint32_t acc = 0;
    for (int s = 1; s <= n1 + 31; ++s) {
      const int x = s - lane;
      // lane - 1's cell of the step before: (y - 1, x); lane 0 reads it
      // from the row buffer, where the strip above left it
      const int shW = __shfl_up_sync(kFull, W, 1);
      const int shY = __shfl_up_sync(kFull, Y, 1);
      const int xb = min(max(x, 0), n1);
      const int upW = lane == 0 ? rowW[xb] : shW;
      const int upY = lane == 0 ? rowY[xb] : shY;
      const bool live = row && x >= 1 && x <= n1;
      const int Xn = max(X + ge, W + go);
      const int Yn = max(upY + ge, upW + go);
      const int d = diagW + trow[c1[min(max(x - 1, 0), max(n1 - 1, 0))]];
      const int Wn = max(d, max(Xn, Yn));
      const int k = (x - 1) & 15;
      if (live) {
        acc |= ((uint32_t)(Wn == d) | ((uint32_t)(Wn == Xn) << 1)) << (2 * k);
        W = Wn;
        X = Xn;
        Y = Yn;
        if (k == 15 || x == n1) {
          brow[(x - 1) >> 4] = acc;
          acc = 0;
        }
        if (lane == 31) {
          rowW[x] = Wn;
          rowY[x] = Yn;
        }
      }
      if (x >= 0 && x <= n1) diagW = upW;
    }
    __syncwarp();
  }

  if (lane == 0) {
    int y = n2, x = n1, ng = 0;
    bool go1 = false, go2 = false;
    long long cur = -1;
    uint32_t word = 0;
    while (y > 0 && x > 0) {
      const long long wi = (long long)(y - 1) * words + ((x - 1) >> 4);
      if (wi != cur) {
        word = pb[wi];
        cur = wi;
      }
      const uint32_t b = (word >> (2 * ((x - 1) & 15))) & 3u;
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
  }
  __syncwarp();
  int* cp = counts + (size_t)p * dim * dim;
  for (int i = lane; i < dim * dim; i += 32) cp[i] = hist[i];
}

template <typename CodeT>
int launch_nw(const void* s1b, const void* s2b, const int* l1, const int* l2,
              const int* scoring, int T, int go, int ge, int dim, int B,
              int L1, int L2, int warps, int smem_bytes, uint32_t* bits,
              int* counts, int* gaps, cudaStream_t stream) {
  const int need = 4 * (T * T + warps * warp_ints<CodeT>(L1, L2, dim));
  if (B < 1 || warps < 1 || warps > 8 || smem_bytes < need)
    return (int)cudaErrorInvalidValue;
  if (smem_bytes > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(nw_kernel<CodeT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const int words = (L1 + 15) / 16;
  nw_kernel<CodeT><<<(B + warps - 1) / warps, 32 * warps, smem_bytes,
                     stream>>>(
      static_cast<const CodeT*>(s1b), static_cast<const CodeT*>(s2b), l1, l2,
      scoring, T, go, ge, dim, B, L1, L2, words, bits, counts, gaps);
  return (int)cudaGetLastError();
}

}  // namespace

// s1b [B, L1], s2b [B, L2] codes of `code_bytes` (1: uint8, 4: int32),
// l1, l2 [B], scoring [T, T] int32; `bits` scratch of B * L2 * ((L1 + 15)
// / 16) words; out counts [B, dim, dim], gaps [B] int32.
extern "C" int pgm_nw(const void* s1b, const void* s2b, const int* l1,
                      const int* l2, const int* scoring, int T, int go,
                      int ge, int dim, int B, int L1, int L2, int code_bytes,
                      int warps, int smem_bytes, void* bits, int* counts,
                      int* gaps, void* stream) {
  uint32_t* b = static_cast<uint32_t*>(bits);
  cudaStream_t st = (cudaStream_t)stream;
  if (code_bytes == 1)
    return launch_nw<uint8_t>(s1b, s2b, l1, l2, scoring, T, go, ge, dim, B,
                              L1, L2, warps, smem_bytes, b, counts, gaps, st);
  if (code_bytes == 4)
    return launch_nw<int>(s1b, s2b, l1, l2, scoring, T, go, ge, dim, B, L1,
                          L2, warps, smem_bytes, b, counts, gaps, st);
  return (int)cudaErrorInvalidValue;
}
