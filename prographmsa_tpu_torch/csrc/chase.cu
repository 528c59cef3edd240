// Code-chase traceback of the graph-pair DP (kernel X1).
//
// Replaces the XLA device program of prographmsa_tpu/align/graph_dp_pallas.py
// (_make_chase.chase, a batch-lockstep while_loop, and _jit_pack).  A pair's
// decision-code plane is walked serially from the end cell to the origin:
//   * the end transition replays the host argmin (align/backtrack.py:75-108)
//     from the fill's final M/X/Y rings, candidates in descending slot order
//     (g1 outer, g2 inner, then M, Y, X, skip), first index on ties;
//   * interior steps decode the fill's code word; boundary steps (x == 0 in
//     state Y, y == 0 in state X) replay the host argmin
//     (backtrack.py:140-172) on the exported boundary stripes, because the
//     fill scored those cells with start_gap but the backtrack compares
//     candidates built with gap_init;
//   * a step through a repeat slot records an event (side, next node, current
//     node, emit position); the host splices markAlternativePath columns in
//     at those positions.  More than EV_CAP events sets fail_rep.
//   * a walk that does not reach the origin within Lm steps, or decodes a
//     slot the pair does not have, sets fail_chase.  The two flags are
//     separate so the harvest can count fb_rep and fb_chase apart.
// Output row per pair (int32): m1[Lm], m2[Lm] (walk order, -2 padded),
// meta[4] = (Wend bits, length, fail_rep, fail_chase),
// ev[1 + 4*EV_CAP] = (count, sides, next nodes, current nodes, positions):
// the whole batch comes back in one copy.
//
// What bounds X1 on the H100: the walk is one chain of dependent reads, a
// step's code word gives the next cell.  Bytes and operations are nothing;
// the floor is the longest walk's steps times one dependent read, and the
// design decides which memory that read goes to.  A pair gets a block
// (chase_cuda.plan_chase: one warp, more where the end transition has many
// slot pairs or the row is long), and:
//   * the code plane comes to the walk.  The walk only moves to smaller y
//     and smaller x, so a window of win x win cells ending at the current
//     cell holds every cell the next steps can reach until one leaves it.
//     The warp fills the window with cp.async, one cell per lane along each
//     diagonal (the plane is diagonal-major, so these are contiguous); a
//     step inside the window is a shared-memory read.  A step that leaves
//     the window, by however far, restarts it at the target cell;
//   * the slot offsets O1/O2 sit in shared memory, and the block packs the
//     repeat flags once into one 64-bit mask of slots per node, so a step's
//     chain is shared-memory reads only and its flag reads (which depend on
//     the cell alone, not on the decoded slot) leave the chain;
//   * with memory out of the way a step is bound by its own chain of
//     dependent instructions, so the decode is written without branches
//     (the three states' fields are selected, not branched to), a step
//     stores its mapping entry without a test, and everything rare (a
//     boundary replay, a repeat step, a slot the pair does not have, a step
//     out of the window, a full row) hides behind one test;
//   * all 32 lanes of the walking warp run the walk in lockstep on the same
//     state, so the parts that split over lanes need no hand-over: window
//     fills, the boundary replays (each lane scans a strided subset of the
//     slots in index order, a shuffle butterfly keeps the smaller
//     difference and then the smaller index, which is the sequential
//     "first index at the minimum"), and the mapping stores, which wait in
//     shared memory and leave at each window fill as coalesced stores;
//   * the end transition splits its nl1 x nl2 slot pairs over the whole
//     block the same way (a plain max first, then first index at minimal
//     |Wend - c|), and the whole block writes the -2 padding, meta and
//     events as coalesced stores.
// pgm_chase_latency times one dependent read from shared memory and from L2
// on the card, for the chain bound chip_smoke.py states.
#include <limits.h>

#include "common.cuh"

namespace {

constexpr int kMaxSlots = 64;
constexpr int kMaxWarps = 8;
constexpr int kTailLen = 4 + 1 + 4 * PGM_EV_CAP;  // meta and events
constexpr int kLatencyWords = 4096;

struct Pair {
  int n1, n2, nl1, nl2, R, n1max, n2max, dfull;
};

__device__ __forceinline__ float tail_at(const float* ring, const Pair& p,
                                         int y, int x) {
  const int d = y + x;
  if ((y == 0 && x == 0) || d > p.dfull || d <= p.dfull - p.R)
    return pgm_f(PGM_NEG_BITS);
  return ring[(size_t)(d % p.R) * p.n1max + y];
}

// Butterfly over the warp: smaller value, then smaller key.
__device__ __forceinline__ void warp_first_min(float& v, int& key) {
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int ok = __shfl_xor_sync(0xffffffffu, key, off);
    if (ov < v || (ov == v && ok < key)) {
      v = ov;
      key = ok;
    }
  }
}

// The same over the block; every thread gets the result.
__device__ __forceinline__ void block_first_min(float& v, int& key,
                                                float* red_v, int* red_k) {
  warp_first_min(v, key);
  const int nwarps = blockDim.x >> 5;
  if (nwarps == 1) return;
  __syncthreads();
  if ((threadIdx.x & 31) == 0) {
    red_v[threadIdx.x >> 5] = v;
    red_k[threadIdx.x >> 5] = key;
  }
  __syncthreads();
  v = red_v[0];
  key = red_k[0];
  for (int w = 1; w < nwarps; ++w) {
    const float ov = red_v[w];
    const int ok = red_k[w];
    if (ov < v || (ov == v && ok < key)) {
      v = ov;
      key = ok;
    }
  }
}

// The four end candidates (M, Y, X, skip) of slot pair `ab` in visit order
// and which of them are valid.
struct EndCand {
  float c[4];
  bool valid, both0;
};

__device__ __forceinline__ EndCand end_cands(
    int ab, const Pair& p, const int* o1s, const int* o2s, const float* c1,
    const float* c2, const float* rM, const float* rY, const float* rX,
    float em, float eg, float es) {
  const float big = pgm_f(PGM_BIG_BITS);
  const float cinf = pgm_f(PGM_COST_INF_BITS);
  const int a = ab / p.nl2, bb = ab - a * p.nl2;
  const int i = p.nl1 - 1 - a, j = p.nl2 - 1 - bb;
  const int yp = p.n1 - 1 - o1s[i], xp = p.n2 - 1 - o2s[j];
  const float cy = c1[(size_t)i * p.n1max + p.n1 - 1];
  const float cx = c2[(size_t)j * p.n2max + p.n2 - 1];
  const int yc = max(yp, 0), xc = max(xp, 0);
  EndCand e;
  e.valid = yp >= 0 && xp >= 0 && cy < cinf && cx < cinf;
  e.both0 = yp == 0 && xp == 0;
  e.c[0] = __fsub_rn(__fsub_rn(__fadd_rn(tail_at(rM, p, yc, xc), em), cy), cx);
  e.c[1] = __fsub_rn(__fsub_rn(__fadd_rn(tail_at(rY, p, yc, xc), eg), cy), cx);
  e.c[2] = __fsub_rn(__fsub_rn(__fadd_rn(tail_at(rX, p, yc, xc), eg), cy), cx);
  e.c[3] = e.both0 ? __fsub_rn(__fsub_rn(es, cy), cx) : -big;
  return e;
}

// One block per pair.  Dynamic shared memory, for a window of `win` cells a
// side: int wcode[win * win], o1s[64], o2s[64], mb1[2 * win], mb2[2 * win];
// uint64 rm1[n1max],
// rm2[n2max] (bit i: slot i's edge into the node is a repeat edge).
// `stats`, if not null, receives per pair (steps, window fills, boundary
// replays).
__global__ void __launch_bounds__(32 * kMaxWarps) chase_kernel(
    const int* __restrict__ codes, const float* __restrict__ ringM,
    const float* __restrict__ ringX, const float* __restrict__ ringY,
    const float* __restrict__ stripeY, const float* __restrict__ stripeX,
    const int* __restrict__ O1, const int* __restrict__ O2,
    const float* __restrict__ C1T, const float* __restrict__ C2T,
    const uint8_t* __restrict__ R1T, const uint8_t* __restrict__ R2T,
    const int* __restrict__ iv, const float* __restrict__ par, int D,
    int n1max, int n2max, int opmax, int Rmax, int Lm, int win,
    int* __restrict__ out, int* __restrict__ stats) {
  extern __shared__ int dyn[];
  __shared__ float red_v[kMaxWarps];
  __shared__ int red_k[kMaxWarps];
  __shared__ int evs[1 + 4 * PGM_EV_CAP];
  __shared__ int fin[4];  // Wend bits, length, fail_rep, fail_chase

  int* wcode = dyn;
  int* o1s = wcode + win * win;
  int* o2s = o1s + kMaxSlots;
  int* mb1 = o2s + kMaxSlots;  // mapping entries since the last flush
  int* mb2 = mb1 + 2 * win;
  unsigned long long* rm1 =
      reinterpret_cast<unsigned long long*>(mb2 + 2 * win);
  unsigned long long* rm2 = rm1 + n1max;

  const int b = blockIdx.x;
  const int tid = threadIdx.x, T = blockDim.x;
  int lane;  // read once: the compiler would re-read the register per step
  asm volatile("mov.u32 %0, %%laneid;" : "=r"(lane));
  int* m1 = out + (size_t)b * (2 * Lm + kTailLen);
  int* m2 = m1 + Lm;
  int* meta = m2 + Lm;

  const int* ivb = iv + b * PGM_IV_W;
  Pair p;
  p.n1 = ivb[PGM_IV_N1];
  p.n2 = ivb[PGM_IV_N2];
  p.nl1 = ivb[PGM_IV_NL1];
  p.nl2 = ivb[PGM_IV_NL2];
  p.R = ivb[PGM_IV_R];
  p.n1max = n1max;
  p.n2max = n2max;
  p.dfull = p.n1 + p.n2 - 2;
  const int shb = ivb[PGM_IV_SHB];
  const float* pb = par + b * PGM_PAR_W;
  const float ge = pb[0], gi = pb[1], si = pb[3];
  const float em = pb[4], eg = pb[5], es = pb[6];
  const float neg = pgm_f(PGM_NEG_BITS);
  const float big = pgm_f(PGM_BIG_BITS);
  const float cinf = pgm_f(PGM_COST_INF_BITS);
  const float inf = __int_as_float(0x7f800000);
  const int smask = (1 << shb) - 1;
  const float* c1 = C1T + (size_t)b * opmax * n1max;
  const float* c2 = C2T + (size_t)b * opmax * n2max;
  const uint8_t* r1 = R1T + (size_t)b * opmax * n1max;
  const uint8_t* r2 = R2T + (size_t)b * opmax * n2max;
  const int* cd = codes + (size_t)b * D * n1max;
  const size_t roff = (size_t)b * Rmax * n1max;
  const float* rM = ringM + roff;
  const float* rY = ringY + roff;
  const float* rX = ringX + roff;
  const float* sY = stripeY + (size_t)b * n1max;
  const float* sX = stripeX + (size_t)b * n2max;

  for (int t = tid; t < kMaxSlots; t += T) {
    o1s[t] = (t < opmax) ? O1[b * opmax + t] : 1;
    o2s[t] = (t < opmax) ? O2[b * opmax + t] : 1;
  }
  for (int t = tid; t < 1 + 4 * PGM_EV_CAP; t += T) evs[t] = 0;
  for (int yy = tid; yy < p.n1; yy += T) {
    unsigned long long m = 0;
#pragma unroll 4
    for (int i = 0; i < p.nl1; ++i)
      m |= (unsigned long long)(r1[(size_t)i * n1max + yy] != 0) << i;
    rm1[yy] = m;
  }
  for (int xx = tid; xx < p.n2; xx += T) {
    unsigned long long m = 0;
#pragma unroll 4
    for (int j = 0; j < p.nl2; ++j)
      m |= (unsigned long long)(r2[(size_t)j * n2max + xx] != 0) << j;
    rm2[xx] = m;
  }
  __syncthreads();

  // ---- end transition: Wend = max of the valid candidates, then the first
  // candidate at minimal |Wend - c| (GraphAlign.h:304-353).  Thread tid
  // takes the slot pairs tid, tid + T, ... in visit order.
  const int nab = p.nl1 * p.nl2;
  float Wend = -big;
  for (int ab = tid; ab < nab; ab += T) {
    const EndCand e =
        end_cands(ab, p, o1s, o2s, c1, c2, rM, rY, rX, em, eg, es);
    for (int t = 0; t < 4; ++t)
      if (e.valid && (t < 3 || e.both0) && e.c[t] > Wend) Wend = e.c[t];
  }
  {
    float nv = -Wend;  // the block's max as a min; keys play no part
    int nk = 0;
    block_first_min(nv, nk, red_v, red_k);
    Wend = -nv;
  }
  float best = inf;
  int kbest = INT_MAX;
  for (int ab = tid; ab < nab; ab += T) {
    const EndCand e =
        end_cands(ab, p, o1s, o2s, c1, c2, rM, rY, rX, em, eg, es);
    for (int t = 0; t < 4; ++t) {
      const bool v = e.valid && (t < 3 || e.both0);
      const float diff = v ? fabsf(__fsub_rn(Wend, e.c[t])) : big;
      if (kbest == INT_MAX || diff < best) {
        best = diff;
        kbest = 4 * ab + t;
      }
    }
  }
  block_first_min(best, kbest, red_v, red_k);

  if (tid < 32) {
    // ---- the walk: warp 0, every lane on the same state
    const int t0 = kbest & 3, ab0 = kbest >> 2;
    const int i0 = p.nl1 - 1 - ab0 / p.nl2;
    const int j0 = p.nl2 - 1 - ab0 % p.nl2;
    int y = max(p.n1 - 1 - o1s[i0], 0);
    int x = max(p.n2 - 1 - o2s[j0], 0);
    int st = (t0 == 0) ? PGM_ST_M : ((t0 == 1) ? PGM_ST_Y : PGM_ST_X);
    if (t0 == 3) y = x = 0;

    int pos = 0, evn = 0, fail_rep = 0, fail_chase = 0;
    int nbuf = 0;  // entries pos - nbuf .. pos - 1 wait in mb1 / mb2
    int yb = 0, xb = 0;              // the window's first row and column
    int wofs = 0;                    // cell (y, x) is wcode[wofs + y * win + x]
    int n_fill = 0, n_replay = 0, it = 0;

    // A step stores its entry to shared memory (every lane the same word)
    // and tests nothing: the buffer is flushed where the window is filled,
    // and a window of win cells a side holds fewer than 2 * win steps.
    auto push = [&](int v1, int v2) {
      mb1[nbuf] = v1;
      mb2[nbuf] = v2;
      ++nbuf;
      ++pos;
    };
    auto flush = [&]() {
      __syncwarp();
      for (int k = lane; k < nbuf; k += 32) {
        m1[pos - nbuf + k] = mb1[k];
        m2[pos - nbuf + k] = mb2[k];
      }
      __syncwarp();
      nbuf = 0;
    };
    auto event = [&](int side, int nxt, int cur) {
      if (evn >= PGM_EV_CAP) {
        fail_rep = 1;
        return;
      }
      if (lane == 0) {
        evs[1 + evn] = side;
        evs[1 + PGM_EV_CAP + evn] = nxt;
        evs[1 + 2 * PGM_EV_CAP + evn] = cur;
        evs[1 + 3 * PGM_EV_CAP + evn] = pos;
      }
      ++evn;
    };
    // The window ending at cell (yc, xc): rows yc - win + 1 .. yc, columns
    // xc - win + 1 .. xc, as far as they exist.
    auto fill_window = [&](int yc, int xc) {
      flush();
      yb = yc - win + 1;
      xb = xc - win + 1;
      wofs = -(yb * win + xb);
      const int ylo = max(yb, 0), xlo = max(xb, 0);
      const int rows = yc - ylo + 1, cols = xc - xlo + 1;
      // lane r owns row ylo + r; at turn t every lane is on diagonal
      // ylo + xlo + t, so one turn's copies are contiguous in the plane
      for (int r = lane; r < rows; r += 32) {
        const int yy = ylo + r;
        const int* src = cd + (size_t)(ylo + xlo) * n1max + yy;
        unsigned dst = (unsigned)__cvta_generic_to_shared(
            wcode + (yy - yb) * win + (xlo - xb) - r);
        for (int t = 0; t < rows + cols - 1; ++t, src += n1max, dst += 4)
          if ((unsigned)(t - r) < (unsigned)cols) cp_async4(dst, src);
      }
      cp_async_wait_all();
      __syncwarp();
      ++n_fill;
    };

    push(p.n1 - 1, p.n2 - 1);
    // y-side mark, then x-side mark, both before the push of (y, x)
    if ((rm1[p.n1 - 1] >> i0) & 1) event(1, y, p.n1 - 1);
    if ((rm2[p.n2 - 1] >> j0) & 1) event(2, x, p.n2 - 1);
    if ((x != 0 || y != 0) && !fail_rep)
      push((st == PGM_ST_X) ? -1 : y, (st == PGM_ST_Y) ? -1 : x);
    fill_window(y, x);
    int code = wcode[wofs + y * win + x];

    // shifts of the code word's fields: M (i, j), Y (re-entry bit, i),
    // X (re-entry bit, j), the state a re-entry goes to
    const int shYrw = 2 * shb, shYi = 2 * shb + 1;
    const int shXrw = 3 * shb + 1, shXj = 3 * shb + 2, shW = 4 * shb + 2;
    int last = Lm - 1;  // in a register, not re-read from the parameters
    asm volatile("" : "+r"(last));
    // Every turn stores an entry or ends the walk, and the length test caps
    // the entries at Lm - 1, so the loop ends without a count of its own.
    while ((y != 0 || x != 0) && !fail_rep) {
      const bool isY = st == PGM_ST_Y, isX = st == PGM_ST_X;
      const unsigned long long f1 = rm1[y], f2 = rm2[x];
      int i_sel = (code >> (isY ? shYi : shb)) & smask;
      int j_sel = (code >> (isX ? shXj : 0)) & smask;
      int rw = isY ? (code >> shYrw) & 1 : (isX ? (code >> shXrw) & 1 : 1);
      // the offset tables are kMaxSlots long, so any decoded slot reads
      int ny = max(y - (isX ? 0 : o1s[i_sel]), 0);
      int nx = max(x - (isY ? 0 : o2s[j_sel]), 0);
      const bool boundary = isY ? x == 0 : (isX && y == 0);
      const bool bad = (!isX & (i_sel >= p.nl1)) | (!isY & (j_sel >= p.nl2));
      // one test for everything rare; the cases then go in the host's order
      if (boundary | bad | ((f1 | f2) != 0) | (ny < yb) | (nx < xb) |
          (pos >= last)) {
        if (boundary) {
          // boundary replay along g1 (state Y) or g2 (state X): the slots
          // split over the lanes
          const int at = isY ? y : x, nl = isY ? p.nl1 : p.nl2;
          const int nmax = isY ? n1max : n2max;
          const int* os = isY ? o1s : o2s;
          const float* cs = isY ? c1 : c2;
          const float* stripe = isY ? sY : sX;
          float bestB = inf;
          int kB = INT_MAX;
          const float cur = stripe[at];
          for (int a = lane; a < nl; a += 32) {
            const int k = nl - 1 - a;
            const int pb = at - os[k];
            const float ck = cs[(size_t)k * nmax + at];
            const float sv = stripe[max(pb, 0)];
            const float ext = (pb == 0) ? neg : sv;
            const float opn = (pb == 0) ? si : sv;
            const bool ok = pb >= 0 && ck < cinf;
            const float d1 = ok ? fabsf(__fsub_rn(cur, __fsub_rn(__fadd_rn(ext, ge), ck))) : big;
            const float d2 = ok ? fabsf(__fsub_rn(cur, __fsub_rn(__fadd_rn(opn, gi), ck))) : big;
            if (kB == INT_MAX || d1 < bestB) { bestB = d1; kB = 2 * a; }
            if (d2 < bestB) { bestB = d2; kB = 2 * a + 1; }
          }
          warp_first_min(bestB, kB);
          if (isY) i_sel = nl - 1 - (kB >> 1);
          else j_sel = nl - 1 - (kB >> 1);
          rw = kB & 1;
          ++n_replay;
        }
        if ((!isX && i_sel >= p.nl1) || (!isY && j_sel >= p.nl2)) {
          fail_chase = 1;
          break;
        }
        ny = max(y - (isX ? 0 : o1s[i_sel]), 0);
        nx = max(x - (isY ? 0 : o2s[j_sel]), 0);
        if (!isX && ((f1 >> i_sel) & 1)) event(1, ny, y);
        if (!isY && ((f2 >> j_sel) & 1)) event(2, nx, x);
        if (fail_rep) break;
        if (ny < yb || nx < xb) fill_window(ny, nx);
        if ((ny != 0 || nx != 0) && pos >= last) {
          fail_chase = 1;
          break;
        }
      }
      const int code2 = wcode[wofs + ny * win + nx];
      const int nst =
          (rw == 1) ? ((code2 >> shW) & 3) : (isY ? PGM_ST_Y : PGM_ST_X);
      if (ny != 0 || nx != 0)
        push((nst == PGM_ST_X) ? -1 : ny, (nst == PGM_ST_Y) ? -1 : nx);
      ++it;
      y = ny;
      x = nx;
      st = nst;
      code = code2;
    }
    if (!fail_rep && (y != 0 || x != 0)) fail_chase = 1;
    if (!fail_rep && !fail_chase) push(0, 0);
    flush();
    if (lane == 0) {
      fin[0] = __float_as_int(Wend);
      fin[1] = pos;
      fin[2] = fail_rep;
      fin[3] = fail_chase;
      evs[0] = evn;
      if (stats != nullptr) {
        stats[3 * b] = it;
        stats[3 * b + 1] = n_fill;
        stats[3 * b + 2] = n_replay;
      }
    }
  }
  __syncthreads();

  // ---- the rest of the row, by the whole block
  for (int k = fin[1] + tid; k < Lm; k += T) m1[k] = m2[k] = -2;
  for (int k = tid; k < kTailLen; k += T) meta[k] = (k < 4) ? fin[k] : evs[k - 4];
}

// One thread follows `steps` dependent reads through a cyclic permutation
// `perm` of 0 .. n - 1, held in shared memory (n == kLatencyWords) or in
// global memory read past L1 (n sized to stay in L2).
__global__ void latency_kernel(const int* __restrict__ perm, int n, int steps,
                               int in_shared, int* sink) {
  __shared__ int s[kLatencyWords];
  int idx = 0;
  if (in_shared) {
    for (int t = 0; t < kLatencyWords; ++t) s[t] = perm[t];
    for (int k = 0; k < steps; ++k) idx = s[idx];
  } else {
    for (int k = 0; k < steps; ++k) idx = __ldcg(perm + idx);
  }
  *sink = idx + n;
}

}  // namespace

// One block of `threads` threads per pair, a code window of `win` cells a
// side in `smem_bytes` of dynamic shared memory (chase_cuda.plan_chase).
extern "C" int pgm_chase(const int* codes, const float* ringM,
                         const float* ringX, const float* ringY,
                         const float* stripeY, const float* stripeX,
                         const int* O1, const int* O2, const float* C1T,
                         const float* C2T, const uint8_t* R1T,
                         const uint8_t* R2T, const int* iv, const float* par,
                         int B, int D, int n1max, int n2max, int opmax,
                         int Rmax, int Lm, int threads, int win,
                         int smem_bytes, int* out, int* stats, void* stream) {
  const int need =
      4 * (win * win + 2 * kMaxSlots + 4 * win) + 8 * (n1max + n2max);
  if (opmax > kMaxSlots || threads < 32 || threads > 32 * kMaxWarps ||
      threads % 32 != 0 || win < 2 || win % 2 != 0 || smem_bytes < need)
    return (int)cudaErrorInvalidValue;
  if (smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        chase_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  chase_kernel<<<B, threads, smem_bytes, (cudaStream_t)stream>>>(
      codes, ringM, ringX, ringY, stripeY, stripeX, O1, O2, C1T, C2T, R1T,
      R2T, iv, par, D, n1max, n2max, opmax, Rmax, Lm, win, out, stats);
  return (int)cudaGetLastError();
}

// `perm`: a cyclic permutation of 0 .. n - 1; n is 4096 with `in_shared`.
extern "C" int pgm_chase_latency(const int* perm, int n, int steps,
                                 int in_shared, int* sink, void* stream) {
  if (n < 1 || (in_shared && n != kLatencyWords))
    return (int)cudaErrorInvalidValue;
  latency_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(perm, n, steps, in_shared,
                                                    sink);
  return (int)cudaGetLastError();
}
