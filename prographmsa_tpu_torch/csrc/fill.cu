// Antidiagonal M/X/Y/W wavefront fill of the graph-pair DP (kernel K3).
//
// Replaces the Pallas kernel of prographmsa_tpu/align/graph_dp_pallas.py
// (_make_kernel.kernel), which packs 8 pairs per grid step into the TPU's
// sublanes and visits every offset slot of every cell, because the TPU has no
// gathers.  This card has gathers, 132 SMs and a dependency chain of
// D = n1 + n2 - 2 diagonals per pair, so the design is about the cost of one
// diagonal and about how many SMs one pair can use:
//
//   * A thread block CLUSTER owns one pair (1, 2, 4, 8 or, where the card
//     can hold the non-portable size, 16 blocks, chosen by the wrapper's
//     plan from the launch's pair count and sizes).  Each block
//     owns a band of rows y; the cluster walks the diagonals d = 1 .. D with
//     one barrier per diagonal (cluster.sync(), or __syncthreads() for a
//     cluster of one).
//   * Only the slots that have an edge into the node are visited.  A prologue
//     kernel compacts C1T/C2T into per-node lists in visit order (descending
//     slot).  An edge-less slot costs COST_INF, its candidate is about NEG
//     and loses to every candidate that has both edges; where no candidate
//     has both edges the stored value is clamped to NEG either way.  So
//     values are the same in every cell, and decision codes are the same in
//     every cell whose value is real, which is every cell a path reaches.
//     The plain version (fill_torch) masks the same candidates, so kernel
//     and plain version agree bit for bit on whole planes.
//   * `lanes` (a power of two up to 32) threads share one cell.  Each lane
//     scans a strided subset of the cell's candidates in visit order with
//     the strict-improvement rule, then a shuffle butterfly keeps the larger
//     value and, at equal values, the smaller visit index: the sequential
//     first-attainer scan from FLOOR, in parallel.  NaN never wins (c > a is
//     false), and no winner above FLOOR leaves code 0.
//   * The rings of the last R = reach + 2 diagonals of W, Y and X live in
//     shared memory where 3*R*band floats fit, each block holding its band;
//     a row y - o of a lower band is read from that block's shared memory
//     through the cluster's distributed shared memory.  Otherwise they live
//     in the output rings in global memory (L2; read and written past L1).
//   * No cell divides: the ring slot of diagonal d - o is (d mod R) - o,
//     plus R where that is negative (o < R), and d mod R advances by one per
//     diagonal.  The S row of the next diagonal is copied into shared memory
//     asynchronously while this diagonal computes, a thread that owns one
//     cell keeps the head of its row's list in registers, and the stores
//     nobody waits for (codes, tails, stripes) are issued between the two
//     halves of the cluster barrier, whose release waits for every earlier
//     store of the thread.
//   * The kernel writes every position of codes, rings and stripes itself
//     (padding included), so the wrapper allocates with torch.empty.
//
// What is carried over exactly (decision codes and values depend on it):
// visit order = descending slot index with the repeat slots at the front of
// the kind-split slot arrays (the host PredIterator order); per edge the Y
// (or X) move before the W move; candidate op orders ((w2 + S) - ci) - cj
// and (y + ge) - ci without contraction; fmaxf for the boundary accumulators
// and the NaN-propagating clamp max(v, NEG) for stored values; the boundary
// rules, the W-state order M, Y, X and the code layout M = i << SHB | j,
// Y at 2*SHB, X at 3*SHB+1, W-state at 4*SHB+2.  Cells outside the pair's
// grid (x < 0 or x >= n2) hold NEG and code 0.
//
// Slot fields: 4 or 6 bits (up to 64 slots a side, the JAX package's
// layouts) fit an int32 code word; a launch with more slots (up to 255) is
// the WIDE instantiation: 8-bit fields in an int64 word (M 16 bits, Y at
// 16, X at 25, W-state at 34), and a 64-bit reduction key, visit index in
// the high word and code field in the low one, because a 16-bit M field
// leaves the 32-bit key no room for the visit index.  The narrow kernels
// are unchanged.  Rings of any R: past shared memory (3*R*band floats) the
// global-ring path takes them, and the ring slot arithmetic holds for any
// R > o, which R = max o1 + max o2 + 2 guarantees.
//
// Outputs: codes [B, D, n1max] diagonal-major; the final rings W/Y/X/M
// [B, Rmax, n1max] (slot d % R), which are the end-region tails the chase
// reads; stripeY [B, n1max] = Y[y, 0] and stripeX [B, n2max] = X[0, x].
//
// Bound on the H100: the roofline bound is memory (S read once, codes written
// once); what remains above it is the chain of D barriers, each followed by
// a dependent ring read.
#include "common.cuh"

#include <cooperative_groups.h>
#include <cuda_pipeline.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxSlots = 255;     // 8-bit slot fields
constexpr int kNarrowSlots = 64;   // the most an int32 code word holds
constexpr int kMaxCluster = 16;  // 8 is portable, 16 needs the opt-in
enum { RING_W = 0, RING_Y = 1, RING_X = 2 };

// The code word and the reduction key (visit index << kShift | code field)
// of each width.
template <bool WIDE>
struct Width {
  using Code = int;
  using Key = int;
  static constexpr int kShift = 12;
  static constexpr Key kNoWinner = 0x7fffffff;
};
template <>
struct Width<true> {
  using Code = long long;
  using Key = long long;
  static constexpr int kShift = 32;
  static constexpr Key kNoWinner = 0x7fffffffffffffffLL;
};

struct FillArgs {
  const float* Sdiag;
  const int* O1;
  const int* O2;
  const int2* E1;   // [B, opmax, n1max] (slot | offset << 8, cost bits)
  const int2* E2;   // [B, opmax, n2max]
  const int* cnt1;  // [B, n1max] list lengths
  const int* cnt2;  // [B, n2max]
  const int* iv;
  const float* par;
  int D, n1max, n2max, opmax, Rmax, lanes_log2;
  void* codes;  // int32, or int64 in the WIDE kernel
  float* ringW;
  float* ringY;
  float* ringX;
  float* ringM;
  float* stripeY;
  float* stripeX;
};

// Per-node lists of the slots with an edge into the node, in visit order.
__global__ void fill_lists_kernel(const float* __restrict__ CT,
                                  const int* __restrict__ O,
                                  const int* __restrict__ iv, int side,
                                  int nmax, int opmax, int2* __restrict__ E,
                                  int* __restrict__ cnt) {
  const int b = blockIdx.y;
  const int y = blockIdx.x * blockDim.x + threadIdx.x;
  if (y >= nmax) return;
  const int* ivb = iv + b * PGM_IV_W;
  const int n = ivb[side ? PGM_IV_N2 : PGM_IV_N1];
  const int nl = ivb[side ? PGM_IV_NL2 : PGM_IV_NL1];
  const float cinf = pgm_f(PGM_COST_INF_BITS);
  int k = 0;
  if (y < n) {
    for (int i = nl - 1; i >= 0; --i) {
      const float c = CT[((size_t)b * opmax + i) * nmax + y];
      if (c < cinf) {
        E[((size_t)b * opmax + k) * nmax + y] =
            make_int2(i | (O[b * opmax + i] << 8), __float_as_int(c));
        ++k;
      }
    }
  }
  cnt[(size_t)b * nmax + y] = k;
}

// Butterfly over the `lanes` threads of a cell: larger value, then smaller key.
template <typename Key>
__device__ __forceinline__ void reduce_first_max(unsigned mask, int lanes,
                                                 float& v, Key& key) {
  for (int off = lanes >> 1; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(mask, v, off);
    const Key ok = __shfl_xor_sync(mask, key, off);
    if (ov > v || (ov == v && ok < key)) {
      v = ov;
      key = ok;
    }
  }
}

__device__ __forceinline__ float reduce_fmax(unsigned mask, int lanes,
                                             float v) {
  for (int off = lanes >> 1; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(mask, v, off));
  return v;
}

// One barrier of the pair's blocks, in two halves, so that stores nobody
// waits for (codes, tails, stripes) can be issued between them: a release
// has to see every earlier store of the thread performed, and a store to
// global memory takes a round trip to L2.
__device__ __forceinline__ void pair_arrive(bool cluster) {
  if (cluster)
    asm volatile("barrier.cluster.arrive.release;" ::: "memory");
}

__device__ __forceinline__ void pair_wait(bool cluster) {
  if (cluster)
    asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
  else
    __syncthreads();
}

// ONE_LANE fixes one thread per cell at compile time (chains and the leaf
// levels), which strips the lane bookkeeping from their diagonals.
template <bool SMEM, bool ONE_LANE, bool WIDE>
__global__ void __launch_bounds__(1024) fill_kernel(const FillArgs a) {
  using Code = typename Width<WIDE>::Code;
  using Key = typename Width<WIDE>::Key;
  constexpr int kShift = Width<WIDE>::kShift;
  constexpr Key kNoWinner = Width<WIDE>::kNoWinner;
  extern __shared__ float dyn[];
  __shared__ const float* peer[kMaxCluster];

  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const bool multi = C > 1;
  const int b = blockIdx.x / C;
  const int tid = threadIdx.x, T = blockDim.x;
  const int lanes_log2 = ONE_LANE ? 0 : a.lanes_log2;
  const int lanes = 1 << lanes_log2;
  const int l = tid & (lanes - 1);
  const unsigned gmask =
      (lanes == 32) ? 0xffffffffu
                    : (((1u << lanes) - 1u) << ((tid & 31) & ~(lanes - 1)));

  const int* ivb = a.iv + b * PGM_IV_W;
  const int n1 = ivb[PGM_IV_N1], n2 = ivb[PGM_IV_N2];
  const int R = ivb[PGM_IV_R], shb = ivb[PGM_IV_SHB];
  const float* pb = a.par + b * PGM_PAR_W;
  const float ge = pb[0], gi = pb[1], sg = pb[2], si = pb[3];
  const float neg = pgm_f(PGM_NEG_BITS);
  const float floor_ = pgm_f(PGM_FLOOR_BITS);
  const int n1max = a.n1max, n2max = a.n2max;

  // this block's band of rows
  const int band = (n1 + C - 1) / C;
  const int y0 = rank * band;
  const int rows = max(0, min(band, n1 - y0));
  const int bandmax = (n1max + C - 1) / C;
  float* Sbuf = dyn;               // [2][bandmax]: S of this and the next d
  float* rg = dyn + 2 * bandmax;   // SMEM: [3][R][band]
  const int rsz = R * band;        // one ring in shared memory

  const size_t plane = (size_t)b * a.D * n1max;
  const float* S = a.Sdiag + plane;
  Code* cd = static_cast<Code*>(a.codes) + plane;
  const size_t roff = (size_t)b * a.Rmax * n1max;
  float* gW = a.ringW + roff;
  float* gY = a.ringY + roff;
  float* gX = a.ringX + roff;
  float* gM = a.ringM + roff;
  float* sY = a.stripeY + (size_t)b * n1max;
  float* sX = a.stripeX + (size_t)b * n2max;
  const int2* e1 = a.E1 + (size_t)b * a.opmax * n1max;
  const int2* e2 = a.E2 + (size_t)b * a.opmax * n2max;
  const int* k1 = a.cnt1 + (size_t)b * n1max;
  const int* k2 = a.cnt2 + (size_t)b * n2max;
  const int dfull = n1 + n2 - 2;

  // ---- everything the diagonals do not write: the padded columns this
  // block owns ([ylo, yhi); the last block takes the columns past n1)
  const int ylo = min(y0, n1max);
  const int yhi = (rank == C - 1) ? n1max : min(y0 + band, n1max);
  const int ncol = yhi - ylo;
  for (int idx = tid; idx < a.Rmax * ncol; idx += T) {
    const int at = (idx / ncol) * n1max + ylo + idx % ncol;
    gW[at] = neg;
    gY[at] = neg;
    gX[at] = neg;
    gM[at] = neg;
  }
  for (int y = ylo + tid; y < yhi; y += T) {
    sY[y] = neg;
    cd[y] = 0;
  }
  for (int d = dfull + 1; d < a.D; ++d)
    for (int y = ylo + tid; y < yhi; y += T) cd[(size_t)d * n1max + y] = 0;
  if (yhi > n1) {
    const int plo = max(ylo, n1), pn = yhi - plo;
    for (int idx = tid; idx < dfull * pn; idx += T)
      cd[(size_t)(1 + idx / pn) * n1max + plo + idx % pn] = 0;
  }
  if (rank == 0)
    for (int x = tid; x < n2max; x += T) sX[x] = neg;
  if (SMEM) {
    for (int idx = tid; idx < 3 * rsz; idx += T) rg[idx] = neg;
    if (tid < C) peer[tid] = cluster.map_shared_rank(rg, tid);
  }
  if (dfull >= 1)
    for (int r = tid; r < rows; r += T)
      __pipeline_memcpy_async(&Sbuf[bandmax + r], &S[n1max + y0 + r], 4);
  __pipeline_commit();
  __syncthreads();
  if (rank == 0 && tid == 0) {  // diagonal 0: W[0, 0] = start_init
    if (SMEM) rg[0] = si; else __stcg(&gW[0], si);
  }
  __pipeline_wait_prior(0);
  pair_arrive(multi);
  pair_wait(multi);

  // ring reads: slot s of ring `which` at row `row` (any row <= this band's)
  auto ring_ld = [&](int which, int s, int row) -> float {
    if (SMEM) {
      int lr = row - y0;
      const float* base = rg;
      if (lr < 0) {
        const int kk = (band - 1 - lr) / band;
        base = peer[rank - kk];
        lr += kk * band;
      }
      return base[which * rsz + s * band + lr];
    }
    const float* g = (which == RING_W) ? gW : ((which == RING_Y) ? gY : gX);
    return __ldcg(g + s * n1max + row);
  };
  // ring slot of diagonal d - back (0 < back < R), given slot = d % R
  auto slot_of = [&](int slot, int back) -> int {
    const int s = slot - back;
    return (s < 0) ? s + R : s;
  };

  // a thread that owns one cell keeps its row's list head in registers
  const int cells_per_pass = T >> lanes_log2;
  const bool one_cell = rows <= cells_per_pass;
  const int cell0 = tid >> lanes_log2;
  const bool lane_ok = l < a.opmax;
  int n1c_h = 0;
  int2 e1_h = make_int2(0, 0);
  if (cell0 < rows) {
    n1c_h = k1[y0 + cell0];
    if (lane_ok) e1_h = __ldg(&e1[l * n1max + y0 + cell0]);
  }

  int slot = 0;  // d % R
  Code* cdrow = cd;
  for (int d = 1; d <= dfull; ++d) {
    const int par = d & 1;
    slot = (slot + 1 == R) ? 0 : slot + 1;
    cdrow += n1max;
    if (d < dfull)
      for (int r = tid; r < rows; r += T)
        __pipeline_memcpy_async(&Sbuf[(par ^ 1) * bandmax + r],
                                &S[(size_t)(d + 1) * n1max + y0 + r], 4);
    __pipeline_commit();

    // stores of the thread's last cell wait until the barrier's first half
    bool have = false;
    int st_y = 0, st_x = 0;
    Code st_code = 0;
    float st_M = neg, st_Y = neg, st_X = neg;
    for (int cell = cell0; cell < rows; cell += cells_per_pass) {
      const int y = y0 + cell;
      const int x = d - y;
      const bool in = (x >= 0) && (x < n2);
      // list heads: both sides' loads are issued before either is used
      int n1c = one_cell ? n1c_h : k1[y];
      int2 e1f = e1_h;
      if (!one_cell && lane_ok) e1f = __ldg(&e1[l * n1max + y]);
      int n2c = 0;
      int2 e2f = make_int2(0, 0);
      if (in) {
        n2c = __ldg(&k2[x]);
        if (lane_ok) e2f = __ldg(&e2[l * n2max + x]);
      } else {
        n1c = 0;
      }
      const float Sd = Sbuf[par * bandmax + cell];

      // Y: moves along g1 edges (y - o1, x) -> (y, x)
      float aY = floor_, aYB = floor_;
      Key keyY = kNoWinner;
      for (int t = l; t < n1c; t += lanes) {
        const int2 e = (t == l) ? e1f : __ldg(&e1[t * n1max + y]);
        const int i = e.x & 0xff, o = e.x >> 8;
        const float ci = __int_as_float(e.y);
        float w = neg, yv = neg;
        if (y >= o) {
          const int s = slot_of(slot, o);
          w = ring_ld(RING_W, s, y - o);
          yv = ring_ld(RING_Y, s, y - o);
        }
        const float tge = __fadd_rn(yv, ge);
        const float ca = __fsub_rn(tge, ci);
        if (ca > aY) { aY = ca; keyY = ((Key)(2 * t) << kShift) | (i << 1); }
        const float cb = __fsub_rn(__fadd_rn(w, gi), ci);
        if (cb > aY) {
          aY = cb;
          keyY = ((Key)(2 * t + 1) << kShift) | (i << 1) | 1;
        }
        aYB = fmaxf(aYB, __fsub_rn(fmaxf(tge, __fadd_rn(w, sg)), ci));
      }

      // M: matches from (y - o1, x - o2); g1 edges outer, g2 edges inner
      float aM = floor_;
      Key keyM = kNoWinner;
      const int total = n1c * n2c;
      if (l < total) {
        int ta = 0, tb = l;
        while (tb >= n2c) { tb -= n2c; ++ta; }
        int2 ea = (ta == l) ? e1f : __ldg(&e1[ta * n1max + y]);
        for (int k = l; k < total; k += lanes) {
          const int2 eb = (tb == l) ? e2f : __ldg(&e2[tb * n2max + x]);
          const int i = ea.x & 0xff, o = ea.x >> 8;
          const int j = eb.x & 0xff, p = eb.x >> 8;
          float w2 = neg;
          if (y >= o && x >= p)
            w2 = ring_ld(RING_W, slot_of(slot, o + p), y - o);
          const float c = __fsub_rn(
              __fsub_rn(__fadd_rn(w2, Sd), __int_as_float(ea.y)),
              __int_as_float(eb.y));
          if (c > aM) { aM = c; keyM = ((Key)k << kShift) | (i << shb) | j; }
          tb += lanes;
          if (tb >= n2c) {
            do { tb -= n2c; ++ta; } while (tb >= n2c);
            if (ta < n1c) ea = __ldg(&e1[ta * n1max + y]);
          }
        }
      }

      // X: moves along g2 edges (y, x - o2) -> (y, x)
      float aX = floor_, aXB = floor_;
      Key keyX = kNoWinner;
      for (int t = l; t < n2c; t += lanes) {
        const int2 e = (t == l) ? e2f : __ldg(&e2[t * n2max + x]);
        const int j = e.x & 0xff, p = e.x >> 8;
        const float cj = __int_as_float(e.y);
        float xv = neg, wv = neg;
        if (x >= p) {
          const int s = slot_of(slot, p);
          xv = ring_ld(RING_X, s, y);
          wv = ring_ld(RING_W, s, y);
        }
        const float tge = __fadd_rn(xv, ge);
        const float ca = __fsub_rn(tge, cj);
        if (ca > aX) { aX = ca; keyX = ((Key)(2 * t) << kShift) | (j << 1); }
        const float cb = __fsub_rn(__fadd_rn(wv, gi), cj);
        if (cb > aX) {
          aX = cb;
          keyX = ((Key)(2 * t + 1) << kShift) | (j << 1) | 1;
        }
        aXB = fmaxf(aXB, __fsub_rn(fmaxf(tge, __fadd_rn(wv, sg)), cj));
      }

      if (lanes > 1) {
        reduce_first_max(gmask, lanes, aY, keyY);
        reduce_first_max(gmask, lanes, aM, keyM);
        reduce_first_max(gmask, lanes, aX, keyX);
        aYB = reduce_fmax(gmask, lanes, aYB);
        aXB = reduce_fmax(gmask, lanes, aXB);
      }
      if (l != 0) continue;
      const Key fmask = ((Key)1 << kShift) - 1;
      const Code cY = (keyY == kNoWinner) ? 0 : (Code)(keyY & fmask);
      const Code cM = (keyM == kNoWinner) ? 0 : (Code)(keyM & fmask);
      const Code cX = (keyX == kNoWinner) ? 0 : (Code)(keyX & fmask);

      const bool ylive = (y >= 1) && (y <= n1 - 2);
      const bool xlive = (x >= 1) && (x <= n2 - 2);
      const bool interior = ylive && xlive;
      const bool bx0 = (x == 0) && ylive;
      const bool by0 = (y == 0) && xlive;
      float Mr = interior ? aM : neg;
      float Xr = interior ? aX : (by0 ? aXB : neg);
      float Yr = interior ? aY : (bx0 ? aYB : neg);
      float Wr = interior ? fmaxf(Mr, fmaxf(Xr, Yr))
                          : (bx0 ? aYB : (by0 ? aXB : neg));
      Mr = pgm_clamp_neg(Mr);
      Xr = pgm_clamp_neg(Xr);
      Yr = pgm_clamp_neg(Yr);
      Wr = pgm_clamp_neg(Wr);
      const Code wst =
          (Wr == Mr) ? PGM_ST_M : ((Wr == Yr) ? PGM_ST_Y : PGM_ST_X);
      const Code code = cM | (cY << (2 * shb)) | (cX << (3 * shb + 1)) |
                        (wst << (4 * shb + 2));

      // what the next diagonals read goes out first
      if (SMEM) {
        float* w = rg + slot * band + cell;
        w[RING_W * rsz] = Wr;
        w[RING_Y * rsz] = Yr;
        w[RING_X * rsz] = Xr;
      } else {
        const int at = slot * n1max + y;
        __stcg(&gW[at], Wr);
        __stcg(&gY[at], Yr);
        __stcg(&gX[at], Xr);
      }
      if (have) {  // an earlier cell of this thread: store it now
        __stcs(&cdrow[st_y], st_code);
        if (d > dfull - R) gM[slot * n1max + st_y] = st_M;
        if (st_x == 0) sY[st_y] = st_Y;
        if (st_y == 0 && st_x < n2) sX[st_x] = st_X;
      }
      have = true;
      st_y = y; st_x = x; st_code = in ? code : 0;
      st_M = Mr; st_Y = Yr; st_X = Xr;
    }
    __pipeline_wait_prior(0);
    pair_arrive(multi);
    if (have) {
      __stcs(&cdrow[st_y], st_code);
      if (d > dfull - R) gM[slot * n1max + st_y] = st_M;  // the tails
      if (st_x == 0) sY[st_y] = st_Y;
      if (st_y == 0 && st_x < n2) sX[st_x] = st_X;
    }
    pair_wait(multi);
  }

  if (SMEM) {  // the final rings are the chase's tails
    for (int idx = tid; idx < R * rows; idx += T) {
      const int r = idx / rows, c = idx % rows;
      const int at = r * n1max + y0 + c;
      gW[at] = rg[RING_W * rsz + r * band + c];
      gY[at] = rg[RING_Y * rsz + r * band + c];
      gX[at] = rg[RING_X * rsz + r * band + c];
    }
  }
}

}  // namespace

// Attributes of `kern` and the launch configuration of B clusters.
static cudaError_t fill_config(void (*kern)(const FillArgs), int B,
                               int blocks_per_pair, int threads,
                               int smem_bytes, cudaStream_t st,
                               cudaLaunchConfig_t* cfg,
                               cudaLaunchAttribute* attr) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed,
                           blocks_per_pair > 8 ? 1 : 0);
  if (e != cudaSuccess) return e;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(B * blocks_per_pair);
  cfg->blockDim = dim3(threads);
  cfg->dynamicSmemBytes = smem_bytes;
  cfg->stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = blocks_per_pair;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

// Launches the list prologue and the fill: B clusters of `blocks_per_pair`
// blocks of `threads` threads, `1 << lanes_log2` threads per cell, the W/Y/X
// rings in shared memory iff `smem_rings` (`smem_bytes` of dynamic shared
// memory per block, as fill_cuda.plan_fill computes it).
// Codes are int64 (the WIDE kernel) where opmax > kNarrowSlots, else int32.
extern "C" int pgm_fill(const float* Sdiag, const int* O1, const int* O2,
                        const float* C1T, const float* C2T, const int* iv,
                        const float* par, int B, int D, int n1max, int n2max,
                        int opmax, int Rmax, int blocks_per_pair,
                        int lanes_log2, int threads, int smem_rings,
                        int smem_bytes, int2* E1, int2* E2, int* cnt1,
                        int* cnt2, void* codes, float* ringW, float* ringY,
                        float* ringX, float* ringM, float* stripeY,
                        float* stripeX, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (opmax > kMaxSlots || Rmax >= (1 << 23) ||
      blocks_per_pair > kMaxCluster || threads < 128)
    return (int)cudaErrorInvalidValue;
  const bool wide = opmax > kNarrowSlots;
  const dim3 lb(128);
  fill_lists_kernel<<<dim3((n1max + 127) / 128, B), lb, 0, st>>>(
      C1T, O1, iv, 0, n1max, opmax, E1, cnt1);
  fill_lists_kernel<<<dim3((n2max + 127) / 128, B), lb, 0, st>>>(
      C2T, O2, iv, 1, n2max, opmax, E2, cnt2);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  FillArgs a;
  a.Sdiag = Sdiag; a.O1 = O1; a.O2 = O2; a.E1 = E1; a.E2 = E2;
  a.cnt1 = cnt1; a.cnt2 = cnt2; a.iv = iv; a.par = par;
  a.D = D; a.n1max = n1max; a.n2max = n2max; a.opmax = opmax; a.Rmax = Rmax;
  a.lanes_log2 = lanes_log2;
  a.codes = codes; a.ringW = ringW; a.ringY = ringY; a.ringX = ringX;
  a.ringM = ringM; a.stripeY = stripeY; a.stripeX = stripeX;

  void (*const kerns[8])(const FillArgs) = {
      fill_kernel<false, false, false>, fill_kernel<false, true, false>,
      fill_kernel<true, false, false>,  fill_kernel<true, true, false>,
      fill_kernel<false, false, true>,  fill_kernel<false, true, true>,
      fill_kernel<true, false, true>,   fill_kernel<true, true, true>};
  void (*kern)(const FillArgs) =
      kerns[4 * wide + 2 * (smem_rings != 0) + (lanes_log2 == 0)];
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  e = fill_config(kern, B, blocks_per_pair, threads, smem_bytes, st, &cfg,
                  attr);
  if (e != cudaSuccess) return (int)e;
  e = cudaLaunchKernelEx(&cfg, kern, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// How many clusters of `blocks_per_pair` blocks of `threads` threads and
// `smem_bytes` of dynamic shared memory the card can hold at once (0: such
// a launch would be refused).  The non-portable size 16 depends on the
// card's GPCs, so the wrapper asks before it plans with it.
extern "C" int pgm_fill_max_clusters(int blocks_per_pair, int threads,
                                     int smem_bytes, int* clusters) {
  if (blocks_per_pair > kMaxCluster) return (int)cudaErrorInvalidValue;
  void (*kern)(const FillArgs) = fill_kernel<true, false, false>;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t e = fill_config(kern, 1, blocks_per_pair, threads, smem_bytes,
                              nullptr, &cfg, attr);
  if (e != cudaSuccess) return (int)e;
  if (cudaOccupancyMaxActiveClusters(clusters, kern, &cfg) != cudaSuccess) {
    cudaGetLastError();  // a size the card refuses is an answer: none
    *clusters = 0;
  }
  return (int)cudaSuccess;
}

extern "C" const char* pgm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
