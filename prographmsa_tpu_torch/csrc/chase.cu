// Code-chase traceback of the graph-pair DP (kernel X1).
//
// Replaces the XLA device program of prographmsa_tpu/align/graph_dp_pallas.py
// (_make_chase.chase, a batch-lockstep while_loop, and _jit_pack).  One
// thread owns one pair and walks that pair's decision-code plane serially
// from the end cell to the origin:
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
// Bound on the H100: latency of the dependent code reads along one walk
// (one L2 load per step); the batch gives one warp lane per pair, so a level
// of B pairs fills B lanes.  That is enough for the main path today.
#include "common.cuh"

namespace {

struct Pair {
  int n1, n2, nl1, nl2, R, shb, n1max, n2max, dfull;
};

__device__ __forceinline__ float tail_at(const float* ring, const Pair& p,
                                         int y, int x) {
  const int d = y + x;
  if ((y == 0 && x == 0) || d > p.dfull || d <= p.dfull - p.R)
    return pgm_f(PGM_NEG_BITS);
  return ring[(size_t)(d % p.R) * p.n1max + y];
}

__global__ void chase_kernel(
    const int* __restrict__ codes, const float* __restrict__ ringM,
    const float* __restrict__ ringX, const float* __restrict__ ringY,
    const float* __restrict__ stripeY, const float* __restrict__ stripeX,
    const int* __restrict__ O1, const int* __restrict__ O2,
    const float* __restrict__ C1T, const float* __restrict__ C2T,
    const uint8_t* __restrict__ R1T, const uint8_t* __restrict__ R2T,
    const int* __restrict__ iv, const float* __restrict__ par, int B, int D,
    int n1max, int n2max, int opmax, int Rmax, int Lm, int* __restrict__ out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int W = 2 * Lm + 4 + 1 + 4 * PGM_EV_CAP;
  int* m1 = out + (size_t)b * W;
  int* m2 = m1 + Lm;
  int* meta = m2 + Lm;
  int* ev = meta + 4;
  for (int k = 0; k < Lm; ++k) m1[k] = m2[k] = -2;
  for (int k = 0; k < 4 + 1 + 4 * PGM_EV_CAP; ++k) meta[k] = 0;

  const int* ivb = iv + b * PGM_IV_W;
  Pair p;
  p.n1 = ivb[PGM_IV_N1];
  p.n2 = ivb[PGM_IV_N2];
  p.nl1 = ivb[PGM_IV_NL1];
  p.nl2 = ivb[PGM_IV_NL2];
  p.R = ivb[PGM_IV_R];
  p.shb = ivb[PGM_IV_SHB];
  p.n1max = n1max;
  p.n2max = n2max;
  p.dfull = p.n1 + p.n2 - 2;
  const float* pb = par + b * PGM_PAR_W;
  const float ge = pb[0], gi = pb[1], si = pb[3];
  const float em = pb[4], eg = pb[5], es = pb[6];
  const float neg = pgm_f(PGM_NEG_BITS);
  const float big = pgm_f(PGM_BIG_BITS);
  const float cinf = pgm_f(PGM_COST_INF_BITS);
  const int smask = (1 << p.shb) - 1;
  const int* o1 = O1 + b * opmax;
  const int* o2 = O2 + b * opmax;
  const float* c1 = C1T + (size_t)b * opmax * n1max;
  const float* c2 = C2T + (size_t)b * opmax * n2max;
  const uint8_t* r1 = R1T + (size_t)b * opmax * n1max;
  const uint8_t* r2 = R2T + (size_t)b * opmax * n2max;
  const int* cd = codes + (size_t)b * D * n1max;
  const size_t roff = (size_t)b * Rmax * n1max;
  const float* sY = stripeY + (size_t)b * n1max;
  const float* sX = stripeX + (size_t)b * n2max;

  // ---- end transition: Wend = max of the valid candidates, then the first
  // candidate at minimal |Wend - c| (GraphAlign.h:304-353)
  float Wend = -big;
  int kbest = -1;
  for (int pass = 0; pass < 2; ++pass) {
    float best = 0.0f;
    int k = 0;
    for (int a = 0; a < p.nl1; ++a) {
      const int i = p.nl1 - 1 - a;
      const int yp = p.n1 - 1 - o1[i];
      const float cy = c1[(size_t)i * n1max + p.n1 - 1];
      for (int bb = 0; bb < p.nl2; ++bb, k += 4) {
        const int j = p.nl2 - 1 - bb;
        const int xp = p.n2 - 1 - o2[j];
        const float cx = c2[(size_t)j * n2max + p.n2 - 1];
        const int yc = max(yp, 0), xc = max(xp, 0);
        const bool valid = yp >= 0 && xp >= 0 && cy < cinf && cx < cinf;
        const bool both0 = yp == 0 && xp == 0;
        float c[4];
        c[0] = __fsub_rn(__fsub_rn(__fadd_rn(tail_at(ringM + roff, p, yc, xc), em), cy), cx);
        c[1] = __fsub_rn(__fsub_rn(__fadd_rn(tail_at(ringY + roff, p, yc, xc), eg), cy), cx);
        c[2] = __fsub_rn(__fsub_rn(__fadd_rn(tail_at(ringX + roff, p, yc, xc), eg), cy), cx);
        c[3] = both0 ? __fsub_rn(__fsub_rn(es, cy), cx) : -big;
        for (int t = 0; t < 4; ++t) {
          const bool v = valid && (t < 3 || both0);
          if (pass == 0) {
            if (v && c[t] > Wend) Wend = c[t];
          } else {
            const float diff = v ? fabsf(__fsub_rn(Wend, c[t])) : big;
            if (kbest < 0 || diff < best) { best = diff; kbest = k + t; }
          }
        }
      }
    }
  }
  const int t0 = kbest & 3, ab = kbest >> 2;
  const int i0 = p.nl1 - 1 - ab / p.nl2;
  const int j0 = p.nl2 - 1 - ab % p.nl2;
  int y = max(p.n1 - 1 - o1[i0], 0);
  int x = max(p.n2 - 1 - o2[j0], 0);
  int st = (t0 == 0) ? PGM_ST_M : ((t0 == 1) ? PGM_ST_Y : PGM_ST_X);
  if (t0 == 3) y = x = 0;

  int pos = 0, evn = 0, fail_rep = 0, fail_chase = 0;
  m1[0] = p.n1 - 1;
  m2[0] = p.n2 - 1;
  pos = 1;
  // y-side mark, then x-side mark, both before the push of (y, x)
  const int rep0[2] = {r1[(size_t)i0 * n1max + p.n1 - 1],
                       r2[(size_t)j0 * n2max + p.n2 - 1]};
  const int nxt0[2] = {y, x}, cur0[2] = {p.n1 - 1, p.n2 - 1};
  for (int s = 0; s < 2; ++s) {
    if (!rep0[s]) continue;
    if (evn >= PGM_EV_CAP) { fail_rep = 1; continue; }
    ev[1 + evn] = s + 1;
    ev[1 + PGM_EV_CAP + evn] = nxt0[s];
    ev[1 + 2 * PGM_EV_CAP + evn] = cur0[s];
    ev[1 + 3 * PGM_EV_CAP + evn] = pos;
    ++evn;
  }
  if ((x != 0 || y != 0) && !fail_rep) {
    m1[pos] = (st == PGM_ST_X) ? -1 : y;
    m2[pos] = (st == PGM_ST_Y) ? -1 : x;
    ++pos;
  }
  int code = cd[(size_t)(y + x) * n1max + y];

  for (int it = 0; (y != 0 || x != 0) && !fail_rep && it < Lm; ++it) {
    const bool isY = st == PGM_ST_Y, isX = st == PGM_ST_X;
    int i_sel = (code >> p.shb) & smask;  // M fields
    int j_sel = code & smask;
    int rw = 1;
    if (isY) {
      if (x == 0) {  // boundary replay along g1
        float bestB = 0.0f;
        int kB = -1;
        const float csY = sY[y];
        for (int a = 0; a < p.nl1; ++a) {
          const int i = p.nl1 - 1 - a;
          const int ypb = y - o1[i];
          const float cyb = c1[(size_t)i * n1max + y];
          const float sy = sY[max(ypb, 0)];
          const float yv = (ypb == 0) ? neg : sy;
          const float wv = (ypb == 0) ? si : sy;
          const bool ok = ypb >= 0 && cyb < cinf;
          const float d1 = ok ? fabsf(__fsub_rn(csY, __fsub_rn(__fadd_rn(yv, ge), cyb))) : big;
          const float d2 = ok ? fabsf(__fsub_rn(csY, __fsub_rn(__fadd_rn(wv, gi), cyb))) : big;
          if (kB < 0 || d1 < bestB) { bestB = d1; kB = 2 * a; }
          if (d2 < bestB) { bestB = d2; kB = 2 * a + 1; }
        }
        i_sel = p.nl1 - 1 - (kB >> 1);
        rw = kB & 1;
      } else {
        rw = (code >> (2 * p.shb)) & 1;
        i_sel = (code >> (2 * p.shb + 1)) & smask;
      }
    } else if (isX) {
      if (y == 0) {  // boundary replay along g2
        float bestB = 0.0f;
        int kB = -1;
        const float csX = sX[x];
        for (int a = 0; a < p.nl2; ++a) {
          const int j = p.nl2 - 1 - a;
          const int xpb = x - o2[j];
          const float cxb = c2[(size_t)j * n2max + x];
          const float sx = sX[max(xpb, 0)];
          const float xv = (xpb == 0) ? neg : sx;
          const float wv = (xpb == 0) ? si : sx;
          const bool ok = xpb >= 0 && cxb < cinf;
          const float d1 = ok ? fabsf(__fsub_rn(csX, __fsub_rn(__fadd_rn(xv, ge), cxb))) : big;
          const float d2 = ok ? fabsf(__fsub_rn(csX, __fsub_rn(__fadd_rn(wv, gi), cxb))) : big;
          if (kB < 0 || d1 < bestB) { bestB = d1; kB = 2 * a; }
          if (d2 < bestB) { bestB = d2; kB = 2 * a + 1; }
        }
        j_sel = p.nl2 - 1 - (kB >> 1);
        rw = kB & 1;
      } else {
        rw = (code >> (3 * p.shb + 1)) & 1;
        j_sel = (code >> (3 * p.shb + 2)) & smask;
      }
    }
    if ((!isX && i_sel >= p.nl1) || (!isY && j_sel >= p.nl2)) {
      fail_chase = 1;
      break;
    }
    const int ny = isX ? y : max(y - o1[i_sel], 0);
    const int nx = isY ? x : max(x - o2[j_sel], 0);
    const int rep[2] = {isX ? 0 : r1[(size_t)i_sel * n1max + y],
                        isY ? 0 : r2[(size_t)j_sel * n2max + x]};
    const int nxt[2] = {ny, nx}, cur[2] = {y, x};
    for (int s = 0; s < 2; ++s) {
      if (!rep[s]) continue;
      if (evn >= PGM_EV_CAP) { fail_rep = 1; continue; }
      ev[1 + evn] = s + 1;
      ev[1 + PGM_EV_CAP + evn] = nxt[s];
      ev[1 + 2 * PGM_EV_CAP + evn] = cur[s];
      ev[1 + 3 * PGM_EV_CAP + evn] = pos;
      ++evn;
    }
    if (fail_rep) break;
    const int code2 = cd[(size_t)(ny + nx) * n1max + ny];
    const int wst2 = (code2 >> (4 * p.shb + 2)) & 3;
    const int nst = (rw == 1) ? wst2 : (isY ? PGM_ST_Y : PGM_ST_X);
    if (ny != 0 || nx != 0) {
      if (pos >= Lm - 1) { fail_chase = 1; break; }
      m1[pos] = (nst == PGM_ST_X) ? -1 : ny;
      m2[pos] = (nst == PGM_ST_Y) ? -1 : nx;
      ++pos;
    }
    y = ny;
    x = nx;
    st = nst;
    code = code2;
  }
  if (!fail_rep && (y != 0 || x != 0)) fail_chase = 1;
  if (!fail_rep && !fail_chase) {
    m1[pos] = 0;
    m2[pos] = 0;
    ++pos;
  }
  meta[0] = __float_as_int(Wend);
  meta[1] = pos;
  meta[2] = fail_rep;
  meta[3] = fail_chase;
  ev[0] = evn;
}

}  // namespace

extern "C" int pgm_chase(const int* codes, const float* ringM,
                         const float* ringX, const float* ringY,
                         const float* stripeY, const float* stripeX,
                         const int* O1, const int* O2, const float* C1T,
                         const float* C2T, const uint8_t* R1T,
                         const uint8_t* R2T, const int* iv, const float* par,
                         int B, int D, int n1max, int n2max, int opmax,
                         int Rmax, int Lm, int* out, void* stream) {
  const int threads = 32;
  chase_kernel<<<(B + threads - 1) / threads, threads, 0,
                 (cudaStream_t)stream>>>(
      codes, ringM, ringX, ringY, stripeY, stripeX, O1, O2, C1T, C2T, R1T,
      R2T, iv, par, B, D, n1max, n2max, opmax, Rmax, Lm, out);
  return (int)cudaGetLastError();
}
