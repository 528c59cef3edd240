// Antidiagonal M/X/Y/W wavefront fill of the graph-pair DP (kernel K3).
//
// Replaces the Pallas kernel of prographmsa_tpu/align/graph_dp_pallas.py
// (_make_kernel.kernel), which packs 8 pairs per grid step into the TPU's
// sublanes.  Here one block owns one pair; its threads stride over the rows
// y of the pair and the block walks its own diagonals d = 1 .. n1+n2-2 with
// one __syncthreads() per diagonal.
//
// What is carried over exactly (decision codes and values depend on it):
//   * offset slots visited in DESCENDING slot index, with the repeat slots at
//     the front of the kind-split slot arrays (_offset_costs_rep), so the
//     visit order is the host PredIterator order;
//   * per edge the Y (or X) move before the W move; a strict-improvement
//     max from FLOOR that records the first attainer's code;
//   * candidate op orders ((w2 + S) - ci) - cj and (y + ge) - ci;
//   * fmaxf (NaN-ignoring, as jnp.fmax) for the boundary accumulators,
//     the NaN-propagating clamp max(v, NEG) for the stored values;
//   * the boundary rules, the W-state order M, Y, X and the code layout
//     M = i << SHB | j, Y at 2*SHB, X at 3*SHB+1, W-state at 4*SHB+2.
// Only the pair's own slots are visited (the TPU kernel visits its group's
// maximum): codes in cells no path reaches may differ from the TPU kernel's,
// codes on every path do not.
//
// Dropped, because only the TPU needed them: the lane-rolled C2 window (C2 is
// read at [slot, x] directly), chained-select ring reads, the when_slot
// tuning, 128-lane padding, group padding (_DummyInfo, _form_groups,
// GROUP_SPREAD), the BUCKET / TIER_FLOOR compile knobs and the VMEM-only
// fb_size rule for R = 256 rings.
//
// Layout (one pair per block; all pair arrays padded to the batch maxima):
//   Sdiag / codes [B, D, n1max]   diagonal-major, so a diagonal's reads and
//                                 writes coalesce over y;
//   rings W/Y/X/M [B, Rmax, n1max] the last R = reach + 2 diagonals in global
//                                 memory (L2-resident at these sizes).  The
//                                 wrapper fills them with NEG.  After the fill
//                                 the M/X/Y rings ARE the end-region tails the
//                                 chase reads (the end transition looks back
//                                 at most reach diagonals);
//   stripeY [B, n1max], stripeX [B, n2max]: the boundary values Y[y, 0] and
//                                 X[0, x] for the chase's boundary replay.
//
// Bound on the H100: at short n the per-diagonal barrier latency (n1+n2
// barriers per pair, a few hundred cycles each); at long n the ring reads
// (nl1*nl2 + 2*nl1 + 2*nl2 loads per cell, L1/L2 hits).  Shared-memory rings
// and several diagonals per barrier are later work.
#include "common.cuh"

namespace {

__global__ void fill_kernel(const float* __restrict__ Sdiag,
                            const int* __restrict__ O1,
                            const int* __restrict__ O2,
                            const float* __restrict__ C1T,
                            const float* __restrict__ C2T,
                            const int* __restrict__ iv,
                            const float* __restrict__ par, int D, int n1max,
                            int n2max, int opmax, int Rmax,
                            int* __restrict__ codes, float* ringW,
                            float* ringY, float* ringX, float* ringM,
                            float* __restrict__ stripeY,
                            float* __restrict__ stripeX) {
  __shared__ int so1[64];
  __shared__ int so2[64];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int* ivb = iv + b * PGM_IV_W;
  const int n1 = ivb[PGM_IV_N1], n2 = ivb[PGM_IV_N2];
  const int nl1 = ivb[PGM_IV_NL1], nl2 = ivb[PGM_IV_NL2];
  const int R = ivb[PGM_IV_R], shb = ivb[PGM_IV_SHB];
  const float* pb = par + b * PGM_PAR_W;
  const float ge = pb[0], gi = pb[1], sg = pb[2], si = pb[3];
  const float neg = pgm_f(PGM_NEG_BITS);
  const float cinf = pgm_f(PGM_COST_INF_BITS);
  const float floor_ = pgm_f(PGM_FLOOR_BITS);

  for (int k = tid; k < opmax; k += blockDim.x) {
    so1[k] = O1[b * opmax + k];
    so2[k] = O2[b * opmax + k];
  }
  const float* S = Sdiag + (size_t)b * D * n1max;
  const float* c1 = C1T + (size_t)b * opmax * n1max;
  const float* c2 = C2T + (size_t)b * opmax * n2max;
  int* cd = codes + (size_t)b * D * n1max;
  float* rW = ringW + (size_t)b * Rmax * n1max;
  float* rY = ringY + (size_t)b * Rmax * n1max;
  float* rX = ringX + (size_t)b * Rmax * n1max;
  float* rM = ringM + (size_t)b * Rmax * n1max;
  float* sY = stripeY + (size_t)b * n1max;
  float* sX = stripeX + (size_t)b * n2max;
  if (tid == 0) rW[0] = si;  // diagonal 0: W[0, 0] = start_init
  __syncthreads();

  const int dfull = n1 + n2 - 2;
  for (int d = 1; d <= dfull; ++d) {
    const int slot = d % R;
    for (int y = tid; y < n1; y += blockDim.x) {
      const int x = d - y;
      const bool xin = (x >= 0) && (x < n2);
      const float Sd = S[(size_t)d * n1max + y];

      // Y: moves along g1 edges (y - o1, x) -> (y, x)
      float aY = floor_, aYB = floor_;
      int cY = 0;
      for (int i = nl1 - 1; i >= 0; --i) {
        const int o = so1[i];
        const float ci = c1[(size_t)i * n1max + y];
        const int ds = d - o;
        float w = neg, yv = neg;
        if (ds >= 0 && y >= o) {
          const size_t at = (size_t)(ds % R) * n1max + (y - o);
          w = rW[at];
          yv = rY[at];
        }
        const float tge = __fadd_rn(yv, ge);
        const float ca = __fsub_rn(tge, ci);
        if (ca > aY) { aY = ca; cY = i << 1; }
        const float cb = __fsub_rn(__fadd_rn(w, gi), ci);
        if (cb > aY) { aY = cb; cY = (i << 1) | 1; }
        aYB = fmaxf(aYB, __fsub_rn(fmaxf(tge, __fadd_rn(w, sg)), ci));
      }

      // M: matches from (y - o1, x - o2)
      float aM = floor_;
      int cM = 0;
      for (int i = nl1 - 1; i >= 0; --i) {
        const int o = so1[i];
        const float ci = c1[(size_t)i * n1max + y];
        for (int j = nl2 - 1; j >= 0; --j) {
          const int p = so2[j];
          const float cj = xin ? c2[(size_t)j * n2max + x] : cinf;
          const int ds = d - o - p;
          float w2 = neg;
          if (ds >= 0 && y >= o) w2 = rW[(size_t)(ds % R) * n1max + (y - o)];
          const float c = __fsub_rn(__fsub_rn(__fadd_rn(w2, Sd), ci), cj);
          if (c > aM) { aM = c; cM = (i << shb) | j; }
        }
      }

      // X: moves along g2 edges (y, x - o2) -> (y, x)
      float aX = floor_, aXB = floor_;
      int cX = 0;
      for (int j = nl2 - 1; j >= 0; --j) {
        const int p = so2[j];
        const float cj = xin ? c2[(size_t)j * n2max + x] : cinf;
        const int ds = d - p;
        float xv = neg, wv = neg;
        if (ds >= 0) {
          const size_t at = (size_t)(ds % R) * n1max + y;
          xv = rX[at];
          wv = rW[at];
        }
        const float tge = __fadd_rn(xv, ge);
        const float ca = __fsub_rn(tge, cj);
        if (ca > aX) { aX = ca; cX = j << 1; }
        const float cb = __fsub_rn(__fadd_rn(wv, gi), cj);
        if (cb > aX) { aX = cb; cX = (j << 1) | 1; }
        aXB = fmaxf(aXB, __fsub_rn(fmaxf(tge, __fadd_rn(wv, sg)), cj));
      }

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
      const int wst = (Wr == Mr) ? PGM_ST_M : ((Wr == Yr) ? PGM_ST_Y : PGM_ST_X);
      const int code = cM | (cY << (2 * shb)) | (cX << (3 * shb + 1)) |
                       (wst << (4 * shb + 2));

      cd[(size_t)d * n1max + y] = code;
      const size_t at = (size_t)slot * n1max + y;
      rW[at] = Wr;
      rY[at] = Yr;
      rX[at] = Xr;
      rM[at] = Mr;
      if (x == 0) sY[y] = Yr;
      if (y == 0 && x < n2) sX[x] = Xr;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int pgm_fill(const float* Sdiag, const int* O1, const int* O2,
                        const float* C1T, const float* C2T, const int* iv,
                        const float* par, int B, int D, int n1max, int n2max,
                        int opmax, int Rmax, int threads, int* codes,
                        float* ringW, float* ringY, float* ringX,
                        float* ringM, float* stripeY, float* stripeX,
                        void* stream) {
  fill_kernel<<<B, threads, 0, (cudaStream_t)stream>>>(
      Sdiag, O1, O2, C1T, C2T, iv, par, D, n1max, n2max, opmax, Rmax, codes,
      ringW, ringY, ringX, ringM, stripeY, stripeX);
  return (int)cudaGetLastError();
}

extern "C" const char* pgm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
