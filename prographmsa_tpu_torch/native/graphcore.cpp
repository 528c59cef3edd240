// graphcore: native host engine for the hot per-node-pair kernels.
//
// This is the C++ host tier of the port (the device tier is the batched
// CUDA path in align/graph_dp_cuda.py): the port's own copy of
// prographmsa_tpu/native/graphcore.cpp.  It aligns the pairs the device
// batch hands back, runs the host stages (cleaning, merging, NW counts) and
// is the same-host baseline behind --engine native.
//
// Numerical contract: bit-identical float32 results with align/dp.py /
// align/backtrack.py (which in turn reproduce
// GraphAlign.h:201-534 semantics).  Everything here is
// pure add/sub/fmaxf on float32 in the same operation order — compile with
// -ffp-contract=off so no FMA contraction changes rounding.
//
// Data layout (from Graph.padded(), graph/graph.py:159): per-node padded
// predecessor arrays idx[n,E] (int32, -1 = empty slot) and cost[n,E]
// (float32, repeat-edge costs pre-materialized by the caller).  Padded
// slots contribute -inf candidates in the numpy path and are skipped here —
// identical results.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <tuple>
#include <utility>
#include <vector>

namespace {
const float NEG_INF = -INFINITY;

// max with np.fmax's "drop NaN candidate" direction: returns acc when cand
// is NaN.  Written as a comparison so the compiler emits a single maxss
// (fmaxf itself is a libm call — it cannot be lowered to maxss without a
// no-NaN proof, and it dominated the fill kernel's runtime).
static inline float maxc(float acc, float cand) {
  return cand > acc ? cand : acc;
}
}

extern "C" {

// ---------------------------------------------------------------------
// Graph-pair M/X/Y/W fill (align/dp.py fill_dp; GraphAlign.h:201-280).
// Returns Wend through *wend.
// Packed (CSR) predecessor lists from a padded [n,E] block: start[y] ..
// start[y+1] index into (pi, pc).  Slot order is preserved; padded slots
// (idx < 0) are dropped — they contribute -inf candidates in the numpy
// path, so skipping them is bit-identical (max is order-insensitive and
// fmaxf drops NaN candidates regardless of position).  all_single is set
// when every node except 0 has exactly one predecessor and node 0 has
// none — the dominant shape after clean_graph (near-linear chains), which
// gets a branch-free plain affine-NW inner loop below.
static void pred_csr(int32_t n, int32_t e, const int32_t* idx,
                     const float* cost, std::vector<int32_t>& start,
                     std::vector<int32_t>& pi, std::vector<float>& pc,
                     bool* all_single) {
  start.resize(n + 1);
  pi.reserve((size_t)n);
  pc.reserve((size_t)n);
  int32_t k = 0;
  for (int32_t y = 0; y < n; ++y) {
    start[y] = k;
    const int32_t* row = idx + (int64_t)y * e;
    const float* crow = cost + (int64_t)y * e;
    for (int32_t i = 0; i < e; ++i) {
      if (row[i] < 0) continue;
      pi.push_back(row[i]);
      pc.push_back(crow[i]);
      ++k;
    }
  }
  start[n] = k;
  bool single = (start[1] == 0);
  for (int32_t y = 1; y < n && single; ++y)
    single = (start[y + 1] - start[y]) == 1;
  *all_single = single;
}

void gc_fill_dp(int32_t n1, int32_t n2, int32_t e1, int32_t e2,
                const int32_t* idx1, const float* cost1,
                const int32_t* idx2, const float* cost2,
                const float* S, float ge, float gi, float sg,
                float start_init, float end_match, float end_gap,
                float end_skip, float* M, float* X, float* Y, float* W,
                float* wend) {
  std::vector<int32_t> s1, p1, s2, p2;
  std::vector<float> c1v, c2v;
  bool single1, single2;
  pred_csr(n1, e1, idx1, cost1, s1, p1, c1v, &single1);
  pred_csr(n2, e2, idx2, cost2, s2, p2, c2v, &single2);

#define IDX(a, y, x) a[(int64_t)(y) * n2 + (x)]

  // Every interior cell (1..n1-2, 1..n2-2) is stored unconditionally by
  // the fill loop, so only the boundary rows/columns need the -inf init
  // (backtrack and the end-node pass read them).
  for (int32_t x = 0; x < n2; ++x) {
    IDX(M, 0, x) = NEG_INF; IDX(X, 0, x) = NEG_INF;
    IDX(Y, 0, x) = NEG_INF; IDX(W, 0, x) = NEG_INF;
    IDX(M, n1 - 1, x) = NEG_INF; IDX(X, n1 - 1, x) = NEG_INF;
    IDX(Y, n1 - 1, x) = NEG_INF; IDX(W, n1 - 1, x) = NEG_INF;
  }
  for (int32_t y = 0; y < n1; ++y) {
    IDX(M, y, 0) = NEG_INF; IDX(X, y, 0) = NEG_INF;
    IDX(Y, y, 0) = NEG_INF; IDX(W, y, 0) = NEG_INF;
    IDX(M, y, n2 - 1) = NEG_INF; IDX(X, y, n2 - 1) = NEG_INF;
    IDX(Y, y, n2 - 1) = NEG_INF; IDX(W, y, n2 - 1) = NEG_INF;
  }
  W[0] = start_init;

  // boundary column x = 0 (GraphAlign.h:214-223)
  for (int32_t y = 1; y <= n1 - 2; ++y) {
    float acc = NEG_INF;
    for (int32_t i = s1[y]; i < s1[y + 1]; ++i) {
      int32_t yp = p1[i];
      float cy = c1v[i];
      float cand = maxc(IDX(Y, yp, 0) + ge, IDX(W, yp, 0) + sg) - cy;
      acc = maxc(acc, cand);
    }
    IDX(Y, y, 0) = acc;
    IDX(W, y, 0) = acc;
  }
  // boundary row y = 0 (GraphAlign.h:225-234)
  for (int32_t x = 1; x <= n2 - 2; ++x) {
    float acc = NEG_INF;
    for (int32_t j = s2[x]; j < s2[x + 1]; ++j) {
      int32_t xp = p2[j];
      float cx = c2v[j];
      float cand = maxc(IDX(X, 0, xp) + ge, IDX(W, 0, xp) + sg) - cx;
      acc = maxc(acc, cand);
    }
    IDX(X, 0, x) = acc;
    IDX(W, 0, x) = acc;
  }

  // interior (GraphAlign.h:238-260); row-major is valid because every
  // predecessor index is strictly smaller than its node
  if (single1 && single2 && n1 > 2 && n2 > 2) {
    // one predecessor per node: pred of node y is (p1[y-1], c1v[y-1])
    for (int32_t y = 1; y <= n1 - 2; ++y) {
      const int32_t yp = p1[y - 1];
      const float cy = c1v[y - 1];
      const float* Wp = W + (int64_t)yp * n2;
      const float* Yp = Y + (int64_t)yp * n2;
      const float* Sy = S + (int64_t)y * n2;
      float* My = M + (int64_t)y * n2;
      float* Xy = X + (int64_t)y * n2;
      float* Yy = Y + (int64_t)y * n2;
      float* Wy = W + (int64_t)y * n2;
      // pass 1 (no intra-row dependency — auto-vectorizes): M and Y from
      // the completed predecessor row; Wy doubles as the B = max(M, Y)
      // scratch until pass 2 finalizes it
      for (int32_t x = 1; x <= n2 - 2; ++x) {
        const int32_t xp = p2[x - 1];
        const float cx = c2v[x - 1];
        float m = ((Wp[xp] + Sy[x]) - cy) - cx;
        float sy = maxc(Yp[x] + ge, Wp[x] + gi) - cy;
        My[x] = m;
        Yy[x] = sy;
        Wy[x] = maxc(m, sy);
      }
      // pass 2 (serial in x): the X/W chain.  With B = max(m, sy) and
      // W = max(B, X), max(X+ge, W+gi) = max(X+ge, X+gi, B+gi)
      // = max(X+gmax, B+gi) bit-exactly (max is exact; max(X+ge, X+gi)
      // resolves to the single add X+max(ge,gi) by rounding monotonicity),
      // which shortens the loop-carried dependency to sub+add+max.
      {
        const float gmax = maxc(ge, gi);
        // A[x] = max(X[y,x]+ge, W[y,x]+gi); seed from the boundary column
        float a = maxc(Xy[0] + ge, Wy[0] + gi);
        int32_t prev = 0;
        for (int32_t x = 1; x <= n2 - 2; ++x) {
          const int32_t xp = p2[x - 1];
          if (xp != prev)  // skip edge: recompute A at xp off the chain
            a = maxc(Xy[xp] + ge, Wy[xp] + gi);
          float sx = a - c2v[x - 1];
          float b = Wy[x];
          Xy[x] = sx;
          Wy[x] = maxc(b, sx);
          a = maxc(sx + gmax, b + gi);
          prev = x;
        }
      }
    }
  } else {
    // General multi-predecessor path, restructured from per-cell pred-pair
    // loops into ROW-VECTORIZED passes: for each row y, every (y-pred i)
    // contributes one branch-free sweep over x for the Y candidates and
    // one dense sweep for the FIRST x-predecessor of each column, plus a
    // SPARSE scalar pass over the columns that have extra predecessors
    // (merge skip edges touch only ~10-20% of columns, so the old dense
    // sweep per x-slot wasted e2-1 full passes); the X/W chain stays a
    // serial per-row pass (loop-carried through x).  Every candidate
    // value is computed with the identical float op sequence as the
    // per-cell loop — only the MAX ACCUMULATION ORDER differs, and float
    // max is exact (order-insensitive), so results are bit-identical
    // (asserted by tests/test_native.py).
    // Dense lane = each column's x-1 ("chain") edge, when present: the M
    // sweep then reads Wp[x-1] — a shifted CONTIGUOUS load instead of a
    // gather, so it vectorizes.  Every other x-edge (skip edges, ~10-20%
    // of columns after merges) goes to the sparse extras list.  Max is
    // order-insensitive, so splitting the candidate set this way is
    // bit-identical to any other accumulation order.
    std::vector<float> x0c((size_t)n2, INFINITY);   // x-1 edge cost
    std::vector<int32_t> ex_x, ex_xp;
    std::vector<float> ex_c;
    for (int32_t x = 1; x <= n2 - 2; ++x) {
      for (int32_t j = s2[x]; j < s2[x + 1]; ++j) {
        if (p2[j] == x - 1) {
          x0c[x] = c2v[j];
        } else {
          ex_x.push_back(x);
          ex_xp.push_back(p2[j]);
          ex_c.push_back(c2v[j]);
        }
      }
    }
    const size_t nex = ex_x.size();
    for (int32_t y = 1; y <= n1 - 2; ++y) {
      float* __restrict My = M + (int64_t)y * n2;
      float* __restrict Xy = X + (int64_t)y * n2;
      float* __restrict Yy = Y + (int64_t)y * n2;
      float* __restrict Wy = W + (int64_t)y * n2;
      const float* __restrict Sy = S + (int64_t)y * n2;
      for (int32_t x = 1; x <= n2 - 2; ++x) {
        My[x] = NEG_INF;
        Yy[x] = NEG_INF;
      }
      for (int32_t i = s1[y]; i < s1[y + 1]; ++i) {
        const int32_t yp = p1[i];
        const float cy = c1v[i];
        const float* __restrict Wp = W + (int64_t)yp * n2;
        const float* __restrict Yp = Y + (int64_t)yp * n2;
        const float* __restrict xc = x0c.data();
        for (int32_t x = 1; x <= n2 - 2; ++x) {
          Yy[x] = maxc(Yy[x], maxc(Yp[x] + ge, Wp[x] + gi) - cy);
          My[x] = maxc(My[x], ((Wp[x - 1] + Sy[x]) - cy) - xc[x]);
        }
        for (size_t k = 0; k < nex; ++k) {
          const int32_t x = ex_x[k];
          My[x] = maxc(My[x], ((Wp[ex_xp[k]] + Sy[x]) - cy) - ex_c[k]);
        }
      }
      // X/W chain with the fast path's shortened dependency for chain
      // columns (sole predecessor x-1): max(X+ge, W+gi) with
      // W = max(B, X) equals max(X+gmax, B+gi) bit-exactly (see the
      // single-pred path's proof); skip/multi-pred columns recompute the
      // full CSR max off the stored rows.
      {
        const float gmax = maxc(ge, gi);
        float a = maxc(Xy[0] + ge, Wy[0] + gi);
        for (int32_t x = 1; x <= n2 - 2; ++x) {
          const int32_t j0 = s2[x], j1 = s2[x + 1];
          float sx;
          if (j1 - j0 == 1 && p2[j0] == x - 1) {
            sx = a - c2v[j0];
          } else {
            sx = NEG_INF;
            for (int32_t j = j0; j < j1; ++j)
              sx = maxc(sx, maxc(Xy[p2[j]] + ge, Wy[p2[j]] + gi) - c2v[j]);
          }
          const float b = maxc(My[x], Yy[x]);
          Xy[x] = sx;
          Wy[x] = maxc(b, sx);
          a = maxc(sx + gmax, b + gi);
        }
      }
    }
  }

  // end-node match (GraphAlign.h:262-280)
  float we = NEG_INF;
  for (int32_t i = 0; i < e1; ++i) {
    int32_t yp = idx1[(int64_t)(n1 - 1) * e1 + i];
    if (yp < 0) continue;
    float cy = cost1[(int64_t)(n1 - 1) * e1 + i];
    for (int32_t j = 0; j < e2; ++j) {
      int32_t xp = idx2[(int64_t)(n2 - 1) * e2 + j];
      if (xp < 0) continue;
      float cx = cost2[(int64_t)(n2 - 1) * e2 + j];
      if (xp == 0 && yp == 0) {
        we = maxc(we, ((end_skip - cy) - cx));
      } else {
        we = maxc(we, (((IDX(X, yp, xp) + end_gap) - cy) - cx));
        we = maxc(we, (((IDX(Y, yp, xp) + end_gap) - cy) - cx));
        we = maxc(we, (((IDX(M, yp, xp) + end_match) - cy) - cx));
      }
    }
  }
  *wend = we;
#undef IDX
}

// ---------------------------------------------------------------------
// Backtrack (align/backtrack.py; GraphAlign.h:283-517), repeat-free graphs
// only (the caller routes graphs with repeat edges to the Python walk,
// which handles markAlternativePath).  Emits the mapping pair in *reverse*
// walk order (caller reverses).  Returns the number of emitted columns, or
// -1 on the "backtracking failed" condition.
int32_t gc_backtrack(int32_t n1, int32_t n2, int32_t e1, int32_t e2,
                     const int32_t* idx1, const float* cost1,
                     const int32_t* idx2, const float* cost2,
                     const float* S, const float* M, const float* X,
                     const float* Y, const float* W, float wend, float ge,
                     float gi, float end_match, float end_gap, float end_skip,
                     int32_t* map1, int32_t* map2) {
#define IDX(a, y, x) a[(int64_t)(y) * n2 + (x)]
  enum { SM = 0, SX = 1, SY = 2 };
  int32_t out = 0;
  int32_t y = n1 - 1, x = n2 - 1;
  map1[out] = y;
  map2[out] = x;
  ++out;

  int state = SM;
  float cur = NEG_INF;
  float best = INFINITY;
  // transitions into the end state (GraphAlign.h:304-353)
  for (int32_t i = 0; i < e1; ++i) {
    int32_t yp = idx1[(int64_t)(n1 - 1) * e1 + i];
    if (yp < 0) continue;
    float cy = cost1[(int64_t)(n1 - 1) * e1 + i];
    for (int32_t j = 0; j < e2; ++j) {
      int32_t xp = idx2[(int64_t)(n2 - 1) * e2 + j];
      if (xp < 0) continue;
      float cx = cost2[(int64_t)(n2 - 1) * e2 + j];
      float d = fabsf(wend - (((IDX(M, yp, xp) + end_match) - cy) - cx));
      if (best > d) { best = d; cur = IDX(M, yp, xp); state = SM; y = yp; x = xp; }
      d = fabsf(wend - (((IDX(Y, yp, xp) + end_gap) - cy) - cx));
      if (best > d) { best = d; cur = IDX(Y, yp, xp); state = SY; y = yp; x = xp; }
      d = fabsf(wend - (((IDX(X, yp, xp) + end_gap) - cy) - cx));
      if (best > d) { best = d; cur = IDX(X, yp, xp); state = SX; y = yp; x = xp; }
      if (xp == 0 && yp == 0) {
        d = fabsf(wend - ((end_skip - cy) - cx));
        if (best > d) { best = d; y = yp; x = xp; }
      }
    }
  }

  if (x != 0 || y != 0) {
    map1[out] = (state == SX) ? -1 : y;
    map2[out] = (state == SY) ? -1 : x;
    ++out;
  }

  // non-end transitions (GraphAlign.h:370-517)
  while (x != 0 || y != 0) {
    best = INFINITY;
    float next_score = INFINITY;
    int next_state = SM;
    int32_t nx = -1, ny = -1;

    // resolve W==M / W==Y / W==X (GraphAlign.h:400-411); -2 = failure
    auto resolve = [&](int32_t ry, int32_t rx, float* sc, int* st) -> int {
      float w = IDX(W, ry, rx);
      if (w == IDX(M, ry, rx)) { *sc = IDX(M, ry, rx); *st = SM; return 0; }
      if (w == IDX(Y, ry, rx)) { *sc = IDX(Y, ry, rx); *st = SY; return 0; }
      if (w == IDX(X, ry, rx)) { *sc = IDX(X, ry, rx); *st = SX; return 0; }
      return -1;
    };

    if (state == SY) {
      for (int32_t i = 0; i < e1; ++i) {
        int32_t yp = idx1[(int64_t)y * e1 + i];
        if (yp < 0) continue;
        float cy = cost1[(int64_t)y * e1 + i];
        float d = fabsf(cur - ((IDX(Y, yp, x) + ge) - cy));
        if (best > d) {
          best = d; nx = x; ny = yp;
          next_score = IDX(Y, ny, nx); next_state = SY;
        }
        d = fabsf(cur - ((IDX(W, yp, x) + gi) - cy));
        if (best > d) {
          best = d; nx = x; ny = yp;
          if (nx != 0 || ny != 0)
            if (resolve(ny, nx, &next_score, &next_state)) return -1;
        }
      }
    } else if (state == SX) {
      for (int32_t j = 0; j < e2; ++j) {
        int32_t xp = idx2[(int64_t)x * e2 + j];
        if (xp < 0) continue;
        float cx = cost2[(int64_t)x * e2 + j];
        float d = fabsf(cur - ((IDX(X, y, xp) + ge) - cx));
        if (best > d) {
          best = d; nx = xp; ny = y;
          next_score = IDX(X, ny, nx); next_state = SX;
        }
        d = fabsf(cur - ((IDX(W, y, xp) + gi) - cx));
        if (best > d) {
          best = d; nx = xp; ny = y;
          if (nx != 0 || ny != 0)
            if (resolve(ny, nx, &next_score, &next_state)) return -1;
        }
      }
    } else {
      const float s = IDX(S, y, x);
      for (int32_t i = 0; i < e1; ++i) {
        int32_t yp = idx1[(int64_t)y * e1 + i];
        if (yp < 0) continue;
        float cy = cost1[(int64_t)y * e1 + i];
        for (int32_t j = 0; j < e2; ++j) {
          int32_t xp = idx2[(int64_t)x * e2 + j];
          if (xp < 0) continue;
          float cx = cost2[(int64_t)x * e2 + j];
          float d = fabsf(cur - (((IDX(W, yp, xp) + s) - cy) - cx));
          if (best > d) {
            best = d; ny = yp; nx = xp;
            if (nx != 0 || ny != 0)
              if (resolve(ny, nx, &next_score, &next_state)) return -1;
          }
        }
      }
    }

    x = nx;
    y = ny;
    state = next_state;
    cur = next_score;

    if (x != 0 || y != 0) {
      map1[out] = (state == SX) ? -1 : y;
      map2[out] = (state == SY) ? -1 : x;
      ++out;
    }
  }
  map1[out] = 0;
  map2[out] = 0;
  ++out;
  return out;
#undef IDX
}

// ---------------------------------------------------------------------
// Batched all-pairs Needleman-Wunsch with affine gaps (int32, exact):
// fill + backtrack -> substitution counts + gap-opening counts.  Same
// recurrence/boundaries as distances/align.py _batched_W and the same
// traceback priority (diagonal, then X, then Y) as _backtrack_pair
// (DistanceFactoryAlign.h:59-127 semantics).  Threaded over pairs.
void gc_nw_batch(int32_t n_pairs, int32_t l1max, int32_t l2max,
                 const int32_t* s1, const int32_t* l1, const int32_t* s2,
                 const int32_t* l2, const int32_t* scoring, int32_t table_n,
                 int32_t dim, int32_t go, int32_t ge, int32_t n_threads,
                 int64_t* counts, int32_t* gaps) {
  const int32_t MINFTY = -10000;
  if (n_threads < 1) n_threads = 1;

  auto work = [&](int32_t tid) {
    std::vector<int32_t> Wv, Xv, Yv;
    for (int32_t p = tid; p < n_pairs; p += n_threads) {
      const int32_t L1 = l1[p], L2 = l2[p];
      const int32_t* a = s1 + (int64_t)p * l1max;
      const int32_t* b = s2 + (int64_t)p * l2max;
      const int32_t H = L2 + 1, Wd = L1 + 1;
      Wv.assign((size_t)H * Wd, MINFTY);
      Xv.assign((size_t)H * Wd, MINFTY);
      Yv.assign((size_t)H * Wd, MINFTY);
#define AT(v, y, x) v[(size_t)(y)*Wd + (x)]
      AT(Wv, 0, 0) = 0;
      for (int32_t x = 1; x <= L1; ++x) {
        AT(Wv, 0, x) = go + (x - 1) * ge;
        AT(Xv, 0, x) = go + (x - 1) * ge;
      }
      for (int32_t y = 1; y <= L2; ++y) {
        AT(Wv, y, 0) = go + (y - 1) * ge;
        AT(Yv, y, 0) = go + (y - 1) * ge;
      }
      for (int32_t y = 1; y <= L2; ++y) {
        const int32_t* srow = scoring + (int64_t)b[y - 1] * table_n;
        for (int32_t x = 1; x <= L1; ++x) {
          int32_t nx = AT(Xv, y, x - 1) + ge;
          int32_t wx = AT(Wv, y, x - 1) + go;
          if (wx > nx) nx = wx;
          int32_t ny = AT(Yv, y - 1, x) + ge;
          int32_t wy = AT(Wv, y - 1, x) + go;
          if (wy > ny) ny = wy;
          int32_t m = AT(Wv, y - 1, x - 1) + srow[a[x - 1]];
          if (nx > m) m = nx;
          if (ny > m) m = ny;
          AT(Xv, y, x) = nx;
          AT(Yv, y, x) = ny;
          AT(Wv, y, x) = m;
        }
      }
      // backtrack (DistanceFactoryAlign.h:93-123)
      int64_t* cnt = counts + (int64_t)p * dim * dim;
      memset(cnt, 0, sizeof(int64_t) * dim * dim);
      int32_t g = 0;
      bool go1 = false, go2 = false;
      int32_t y = L2, x = L1;
      while (y != 0 && x != 0) {
        int32_t c1 = a[x - 1], c2 = b[y - 1];
        if (AT(Wv, y, x) ==
            AT(Wv, y - 1, x - 1) + scoring[(int64_t)c2 * table_n + c1]) {
          if (c1 < dim && c2 < dim) cnt[(int64_t)c1 * dim + c2] += 1;
          go1 = go2 = false;
          --x;
          --y;
        } else if (AT(Wv, y, x) == AT(Xv, y, x)) {
          if (!go1) ++g;
          go1 = true;
          go2 = false;
          --x;
        } else {
          if (!go2) ++g;
          go1 = false;
          go2 = true;
          --y;
        }
      }
      gaps[p] = g;
#undef AT
    }
  };

  if (n_threads == 1) {
    work(0);
  } else {
    std::vector<std::thread> ts;
    for (int32_t t = 0; t < n_threads; ++t) ts.emplace_back(work, t);
    for (auto& t : ts) t.join();
  }
}

// ---------------------------------------------------------------------
// Match-score matrix precompute (align/scores.py precompute_scores;
// GraphAlign.h:146-163).  Reproduces the Python path bit-for-bit:
//  * num/t2 accumulate one f32 multiply-add per k step per element, in the
//    same k order (Eigen gebp rounding emulation);
//  * v1/v2 use the 4-lane packet accumulator + predux (l0+l2)+(l1+l3) +
//    scalar tail of _eigen_dot_f32;
//  * the fast-log runs over S in column-major order with the SSE-body /
//    scalar-tail split of ls_log_add (ls_log.h:22-59).
static inline float ls_body(float x, float add) {
    const float A = 2.44247459618085927548717403238913328776812604856114f;
    const float B = -4.2040783745848554315883301529007786406310628696383f;
    const float C = -0.72123729809042963774358701619456664388406302428057f;
    uint32_t bits;
    std::memcpy(&bits, &x, 4);
    int32_t e = (int32_t)(bits >> 23) - 126;
    uint32_t mant = ((bits << 9) >> 9) ^ 0x3F000000u;
    float d;
    std::memcpy(&d, &mant, 4);
    // SSE body: ((b/(d-c)) + add) + (e + a)
    return (B / (d - C) + add) + ((float)e + A);
}

static inline float ls_tail(float x, float add) {
    const float A = 2.44247459618085927548717403238913328776812604856114f;
    const float B = -4.2040783745848554315883301529007786406310628696383f;
    const float C = -0.72123729809042963774358701619456664388406302428057f;
    uint32_t bits;
    std::memcpy(&bits, &x, 4);
    int32_t e = (int32_t)(bits >> 23) - 126;
    uint32_t mant = ((bits << 9) >> 9) ^ 0x3F000000u;
    float d;
    std::memcpy(&d, &mant, 4);
    // scalar tail: ((a + b/(d-c)) + e) + add
    return ((A + B / (d - C)) + (float)e) + add;
}

void gc_precompute_scores(int32_t n1, int32_t n2, int32_t dim,
                          const float* g1s,   // [n1, dim]
                          const float* g2s,   // [n2, dim]
                          const float* M,     // [dim, dim]
                          const float* pi,    // [dim]
                          float match_init,
                          float* S) {         // out [n1, n2]
    // t2 = (M^T . g2)^T accumulated over b (one f32 madd per step).
    // Layouts are transposed so every inner loop is unit-stride and
    // auto-vectorizes; the per-element accumulation ORDER (over b, then
    // over d) is unchanged, so results stay bit-identical.
    std::vector<float> g2T((size_t)dim * n2);       // [dim, n2]
    for (int j = 0; j < n2; ++j)
        for (int b = 0; b < dim; ++b)
            g2T[(size_t)b * n2 + j] = g2s[(size_t)j * dim + b];
    std::vector<float> t2T((size_t)dim * n2, 0.0f); // [dim, n2]
    for (int b = 0; b < dim; ++b) {
        const float* g2row = &g2T[(size_t)b * n2];
        for (int d = 0; d < dim; ++d) {
            float mbd = M[(size_t)b * dim + d];
            float* t2row = &t2T[(size_t)d * n2];
            for (int j = 0; j < n2; ++j)
                t2row[j] = t2row[j] + g2row[j] * mbd;
        }
    }
    // num accumulated over d
    for (size_t m = 0; m < (size_t)n1 * n2; ++m) S[m] = 0.0f;
    for (int i = 0; i < n1; ++i) {
        float* Srow = &S[(size_t)i * n2];
        for (int d = 0; d < dim; ++d) {
            float gd = g1s[(size_t)i * dim + d];
            const float* t2row = &t2T[(size_t)d * n2];
            for (int j = 0; j < n2; ++j)
                Srow[j] = Srow[j] + gd * t2row[j];
        }
    }
    // v = packet dot(g, pi): 4-lane accumulator + predux + scalar tail
    auto packet_dot = [&](const float* A, int n, std::vector<float>& v) {
        int k4 = dim & ~3;
        for (int i = 0; i < n; ++i) {
            float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
            const float* row = &A[(size_t)i * dim];
            for (int k = 0; k < k4; k += 4)
                for (int l = 0; l < 4; ++l)
                    acc[l] = acc[l] + row[k + l] * pi[k + l];
            float res = (acc[0] + acc[2]) + (acc[1] + acc[3]);
            for (int k = k4; k < dim; ++k)
                res = res + row[k] * pi[k];
            v[i] = res;
        }
    };
    std::vector<float> v1(n1), v2(n2);
    packet_dot(g1s, n1, v1);
    packet_dot(g2s, n2, v2);
    for (int i = 0; i < n1; ++i)
        for (int j = 0; j < n2; ++j)
            S[(size_t)i * n2 + j] = S[(size_t)i * n2 + j] / (v1[i] * v2[j]);
    // ls_log: body/tail split follows the COLUMN-major flat index (the
    // reference's Eigen traversal), but each element is independent, so we
    // iterate row-major (contiguous) and derive that index per element.
    size_t total = (size_t)n1 * n2;
    size_t alen = total & ~(size_t)3;
    for (int i = 0; i < n1; ++i) {
        float* Srow = &S[(size_t)i * n2];
        for (int j = 0; j < n2; ++j) {
            size_t m = (size_t)j * n1 + i;
            Srow[j] = (m < alen) ? ls_body(Srow[j], match_init)
                                 : ls_tail(Srow[j], match_init);
        }
    }
}

// ---------------------------------------------------------------------
// CleanedGraph marking + edge compaction (graph/graph.py clean_graph;
// CleanedGraph.h:38-146).  Traversability of a repeat edge uses
// 0 + repeat_ext*(units-1): with repeat_ext = +inf and units == 1 this is
// inf*0 = NaN, and NaN != inf, so the edge IS traversable — the same
// float semantics as the numpy path.  Returns new_dim, or -1 when the
// start/end reachability invariant fails (caller raises).  Emits:
//   mapping[n]                      old -> new index (-1 dropped)
//   e_to/e_from/e_cost (ne_out)     kept normal edges, ascending (to, from)
//   r_to/r_from/r_units (nr_out)    kept repeat edges, ascending
int32_t gc_clean_graph(int32_t n, int32_t E,
                       const int32_t* idx, const float* cost,
                       const uint8_t* isrep, const int32_t* units,
                       float repeat_ext,
                       int32_t* mapping,
                       int32_t* e_to, int32_t* e_from, float* e_cost,
                       int32_t* ne_out,
                       int32_t* r_to, int32_t* r_from, int32_t* r_units,
                       int32_t* nr_out) {
    const float INF = INFINITY;
    std::vector<uint8_t> fw((size_t)n, 0), bw((size_t)n, 0);
    fw[0] = 1;
    bw[n - 1] = 1;
    for (int i = 0; i < n; ++i) mapping[i] = -1;
    mapping[0] = 0;
    int32_t new_dim = 1;

    auto trav_cost = [&](size_t s) -> float {
        if (!isrep[s]) return cost[s];
        return 0.0f + repeat_ext * (float)(units[s] - 1);
    };

    for (int to = n - 1; to >= 1; --to) {
        if (!bw[to]) continue;
        for (int e = 0; e < E; ++e) {
            size_t s = (size_t)to * E + e;
            int p = idx[s];
            if (p < 0) continue;
            float c = trav_cost(s);
            if (!(c == INF)) bw[p] = 1;
        }
    }
    for (int to = 1; to < n; ++to) {
        for (int e = 0; e < E; ++e) {
            size_t s = (size_t)to * E + e;
            int p = idx[s];
            if (p < 0) continue;
            float c = trav_cost(s);
            if (!(c == INF) && fw[p]) {
                fw[to] = 1;
                if (bw[to]) mapping[to] = new_dim++;
                break;
            }
        }
    }
    if (!bw[0] || !fw[n - 1]) return -1;

    int32_t ne = 0, nr = 0;
    for (int to = 0; to < n; ++to) {
        int y = mapping[to];
        if (y == -1) continue;
        for (int e = 0; e < E; ++e) {
            size_t s = (size_t)to * E + e;
            int p = idx[s];
            if (p < 0) continue;
            int x = mapping[p];
            if (x == -1) continue;
            if (!isrep[s]) {
                if (cost[s] != INF) {
                    e_to[ne] = y; e_from[ne] = x; e_cost[ne] = cost[s]; ++ne;
                }
            } else if (units[s] > 0) {
                r_to[nr] = y; r_from[nr] = x; r_units[nr] = units[s]; ++nr;
            }
        }
    }
    *ne_out = ne;
    *nr_out = nr;
    return new_dim;
}

// ---------------------------------------------------------------------
// Ancestral-graph edge construction (align/merge.py
// _homologous_path_edges + _readd_edges + Graph.from_maps edge pass;
// GraphAlign.h:626-722).  The numeric column profiles stay in numpy (they
// depend on BLAS dgemv/nrm2 rounding); this covers the pure edge
// bookkeeping: free homologous-path/skip edges, original-edge re-adding
// with half-life penalties (float32 adds in the numpy op order),
// min-combining, (to, from)-sorted emission, and insertion-time cost
// quantization (min(c,1e4) stored as f32 c-1e4; 0 -> +inf).
static inline void upd_edge(std::vector<std::tuple<int32_t, int32_t,
                                                   float>>& v,
                            int32_t frm, int32_t to, float cost) {
    // min-combining is deferred to a sort + sweep (min is
    // order-insensitive for the finite/+inf costs that reach here, so
    // results equal the old std::map insert-or-min — at ~10x less cost
    // per edge on the merge hot path)
    v.emplace_back(to, frm, cost);
}

static void merge_edges_impl(int32_t n_nodes,
                    const int32_t* m1, const int32_t* m2,
                    const uint8_t* matched,
                    // graph 1
                    int32_t g1n, int32_t g1E, const int32_t* idx1,
                    const float* cost1, const uint8_t* isrep1,
                    const int32_t* units1, const int32_t* inv1,
                    // graph 2
                    int32_t g2n, int32_t g2E, const int32_t* idx2,
                    const float* cost2, const uint8_t* isrep2,
                    const int32_t* units2, const int32_t* inv2,
                    float up1, float up2, int32_t with_penalty,
                    int32_t* e_to, int32_t* e_from, float* e_cost,
                    int32_t* ne_out,
                    int32_t* r_to, int32_t* r_from, int32_t* r_units,
                    int32_t* nr_out) {
    std::vector<std::tuple<int32_t, int32_t, float>> edges;
    edges.reserve((size_t)n_nodes * 4 + (size_t)g1n * g1E
                  + (size_t)g2n * g2E);
    std::vector<std::tuple<int32_t, int32_t, int32_t>> repeats;

    // homologous path + skip edges (GraphAlign.h:626-657)
    int32_t last_xy = 0, last_x = 0, last_y = 0, last_mapped = 0;
    for (int32_t i = 1; i < n_nodes; ++i) {
        if (!matched[i]) continue;
        upd_edge(edges, last_mapped, i, 0.0f);
        last_mapped = i;
        if (m1[i] != -1 && m2[i] != -1) {
            if (last_xy != i - 1) upd_edge(edges, last_xy, i, 0.0f);
            last_xy = i;
        }
        if (m1[i] != -1) {
            if (last_y != i - 1) upd_edge(edges, last_y, i, 0.0f);
            last_y = i;
        }
        if (m2[i] != -1) {
            if (last_x != i - 1) upd_edge(edges, last_x, i, 0.0f);
            last_x = i;
        }
    }

    // re-add original edges with half-life penalties (GraphAlign.h:675-722)
    auto readd = [&](int32_t gn, int32_t gE, const int32_t* idx,
                     const float* cost, const uint8_t* isrep,
                     const int32_t* units, const int32_t* inv, float up) {
        float up_half = up / 2.0f;
        for (int32_t to = 0; to < gn; ++to) {
            for (int32_t e = 0; e < gE; ++e) {
                size_t s = (size_t)to * gE + e;
                int32_t p = idx[s];
                if (p < 0) continue;
                int32_t yy = inv[p];
                int32_t xx = inv[to];
                if (!isrep[s]) {
                    float c = cost[s];
                    if (!with_penalty) upd_edge(edges, yy, xx, c);
                    else if (matched[p] && matched[to])
                        upd_edge(edges, yy, xx, c + up);
                    else if (matched[p] || matched[to])
                        upd_edge(edges, yy, xx, c + up_half);
                    else upd_edge(edges, yy, xx, c);
                } else if (units[s] > 0) {
                    repeats.emplace_back(xx, yy, units[s]);
                }
            }
        }
    };
    readd(g1n, g1E, idx1, cost1, isrep1, units1, inv1, up1);
    readd(g2n, g2E, idx2, cost2, isrep2, units2, inv2, up2);

    // sort by (to, from), min-combine equal keys, quantize on emission
    // (graph.from_maps) — same results as the old std::map in (to, from)
    // key order, without the per-edge node allocations
    std::sort(edges.begin(), edges.end());
    std::sort(repeats.begin(), repeats.end());
    int32_t ne = 0, nr = 0;
    for (size_t k = 0; k < edges.size();) {
        int32_t to = std::get<0>(edges[k]);
        int32_t frm = std::get<1>(edges[k]);
        float cmin = std::get<2>(edges[k]);
        for (++k; k < edges.size() && std::get<0>(edges[k]) == to
                  && std::get<1>(edges[k]) == frm; ++k)
            cmin = std::min(cmin, std::get<2>(edges[k]));
        double d = std::min((double)cmin, 10000.0);
        float c = (float)d;
        float stored = c - 10000.0f;
        float q = (stored == 0.0f) ? INFINITY : stored + 10000.0f;
        e_to[ne] = to;
        e_from[ne] = frm;
        e_cost[ne] = q;
        ++ne;
    }
    for (size_t k = 0; k < repeats.size();) {
        int32_t to = std::get<0>(repeats[k]);
        int32_t frm = std::get<1>(repeats[k]);
        int32_t umin = std::get<2>(repeats[k]);
        for (++k; k < repeats.size() && std::get<0>(repeats[k]) == to
                  && std::get<1>(repeats[k]) == frm; ++k)
            umin = std::min(umin, std::get<2>(repeats[k]));
        if (umin > 0) {
            r_to[nr] = to;
            r_from[nr] = frm;
            r_units[nr] = umin;
            ++nr;
        }
    }
    *ne_out = ne;
    *nr_out = nr;
}

void gc_merge_edges(int32_t n_nodes,
                    const int32_t* m1, const int32_t* m2,
                    const uint8_t* matched,
                    int32_t g1n, int32_t g1E, const int32_t* idx1,
                    const float* cost1, const uint8_t* isrep1,
                    const int32_t* units1, const int32_t* inv1,
                    int32_t g2n, int32_t g2E, const int32_t* idx2,
                    const float* cost2, const uint8_t* isrep2,
                    const int32_t* units2, const int32_t* inv2,
                    float up1, float up2, int32_t with_penalty,
                    int32_t* e_to, int32_t* e_from, float* e_cost,
                    int32_t* ne_out,
                    int32_t* r_to, int32_t* r_from, int32_t* r_units,
                    int32_t* nr_out) {
    merge_edges_impl(n_nodes, m1, m2, matched, g1n, g1E, idx1, cost1,
                     isrep1, units1, inv1, g2n, g2E, idx2, cost2, isrep2,
                     units2, inv2, up1, up2, with_penalty, e_to, e_from,
                     e_cost, ne_out, r_to, r_from, r_units, nr_out);
}

// ---------------------------------------------------------------------
// Padded-array packing of (to, from)-sorted edge arrays — the native form
// of graph.padded_from_edges (normal edges fill each row's leading slots
// in emission order, repeat edges follow).  gc_edge_span returns the
// padded width E = max combined degree (>= 1), or -1 if either array is
// not sorted ascending by 'to' (guard against a future producer with a
// different emission order).  gc_pad_edges fills idx (-1 pad), cost (+inf
// pad), isrep (0/1) and units for preallocated [n, E] outputs.
int32_t gc_edge_span(int32_t n, int32_t ne, const int32_t* e_to,
                     int32_t nr, const int32_t* r_to) {
    std::vector<int32_t> cnt((size_t)n, 0);
    int32_t prev = -1;
    for (int32_t k = 0; k < ne; ++k) {
        if (e_to[k] < prev || e_to[k] >= n) return -1;
        prev = e_to[k];
        ++cnt[e_to[k]];
    }
    prev = -1;
    for (int32_t k = 0; k < nr; ++k) {
        if (r_to[k] < prev || r_to[k] >= n) return -1;
        prev = r_to[k];
        ++cnt[r_to[k]];
    }
    int32_t E = 1;
    for (int32_t i = 0; i < n; ++i) E = std::max(E, cnt[i]);
    return E;
}

void gc_pad_edges(int32_t n, int32_t E,
                  int32_t ne, const int32_t* e_to, const int32_t* e_from,
                  const float* e_cost,
                  int32_t nr, const int32_t* r_to, const int32_t* r_from,
                  const int32_t* r_units,
                  int32_t* idx, float* cost, uint8_t* isrep,
                  int32_t* units) {
    const float inf = INFINITY;
    for (size_t s = 0; s < (size_t)n * E; ++s) {
        idx[s] = -1;
        cost[s] = inf;
        isrep[s] = 0;
        units[s] = 0;
    }
    std::vector<int32_t> fill((size_t)n, 0);
    for (int32_t k = 0; k < ne; ++k) {
        int32_t to = e_to[k];
        size_t s = (size_t)to * E + fill[to]++;
        idx[s] = e_from[k];
        cost[s] = e_cost[k];
    }
    for (int32_t k = 0; k < nr; ++k) {
        int32_t to = r_to[k];
        size_t s = (size_t)to * E + fill[to]++;
        idx[s] = r_from[k];
        isrep[s] = 1;
        units[s] = r_units[k];
    }
}

// ---------------------------------------------------------------------
// Average free-edge path length (align/scores.py average_alignment_length;
// GraphAlign.h:57-96).  preds given as padded idx/cost arrays WITHOUT
// repeat edges (their cost is +inf under (inf, inf) so they never count).
// cache: -1 unvisited, -2 dead end, else average length (double).
static double gc_avg_rec(int cur, const int32_t* idx, const float* cost,
                         int E, std::vector<double>& cache) {
    if (cache[cur] == -1.0) {
        double total = 0.0;
        int paths = 0;
        for (int e = 0; e < E; ++e) {
            int p = idx[(size_t)cur * E + e];
            if (p < 0) continue;
            if (cost[(size_t)cur * E + e] == 0.0f) {
                double res = gc_avg_rec(p, idx, cost, E, cache);
                if (res >= 0.0) {
                    total += res + 1.0;
                    paths += 1;
                }
            }
        }
        cache[cur] = paths > 0 ? total / paths : -2.0;
    }
    return cache[cur];
}

double gc_average_alignment_length(int32_t n, int32_t E,
                                   const int32_t* idx, const float* cost) {
    if (n == 0) return 0.0;
    std::vector<double> cache((size_t)n, -1.0);
    cache[0] = 0.0;
    return gc_avg_rec(n - 1, idx, cost, E, cache);
}

// ---------------------------------------------------------------------
// Ancestral-profile unification (align/merge.py _unify + the model2.P
// fixup; GraphAlign.h:569-620).  The evolved profiles P @ sites[i] and the
// column norms must be bit-identical to numpy's `P @ x` /
// `np.linalg.norm`, so the caller passes raw function pointers to the
// *same* cblas_dgemv / cblas_ddot that numpy's BLAS runs (resolved from
// numpy's own OpenBLAS shared object and self-tested for bitwise equality
// at load, native/__init__.py).  blas64 selects the blasint width.
//
// mode 0 = merge (col1/col2 evolve with P1 — GraphAlign.h:591 quirk —
// mapped two-sided columns multiply P1@g1 by P2@g2, mapped one-sided g2
// columns use P2 per GraphAlign.h:612); mode 1 = incremental (ancestor
// columns copied, child columns evolve with P2).
typedef void (*cblas_dgemv64_t)(int, int, int64_t, int64_t, double,
                                const double*, int64_t, const double*,
                                int64_t, double, double*, int64_t);
typedef double (*cblas_ddot64_t)(int64_t, const double*, int64_t,
                                 const double*, int64_t);
typedef void (*cblas_dgemv32_t)(int, int, int32_t, int32_t, double,
                                const double*, int32_t, const double*,
                                int32_t, double, double*, int32_t);
typedef double (*cblas_ddot32_t)(int32_t, const double*, int32_t,
                                 const double*, int32_t);

namespace {
struct BlasFns {
  void* gemv;
  void* ddot;
  int blas64;
  int dim;
  void matvec(const double* P, const double* x, double* y) const {
    // numpy `P @ x`: cblas_dgemv(RowMajor=101, NoTrans=111, dim, dim,
    // 1.0, P, dim, x, 1, 0.0, y, 1)
    if (blas64)
      ((cblas_dgemv64_t)gemv)(101, 111, dim, dim, 1.0, P, dim, x, 1, 0.0,
                              y, 1);
    else
      ((cblas_dgemv32_t)gemv)(101, 111, dim, dim, 1.0, P, dim, x, 1, 0.0,
                              y, 1);
  }
  double dot(const double* x) const {
    if (blas64) return ((cblas_ddot64_t)ddot)(dim, x, 1, x, 1);
    return ((cblas_ddot32_t)ddot)(dim, x, 1, x, 1);
  }
};

// _norm_or_zero: divide by sqrt(x.x) unless the norm is exactly zero
// (NaN norms divide, matching `n == 0` being false for NaN in Python).
static inline void norm_or_zero(const BlasFns& B, double* v) {
  double n = sqrt(B.dot(v));
  if (n != 0.0)
    for (int k = 0; k < B.dim; ++k) v[k] /= n;
}
}  // namespace

int32_t gc_unify(void* gemv_fn, void* ddot_fn, int32_t blas64, int32_t dim,
                 int32_t mode, int32_t nmap, const int32_t* map1,
                 const int32_t* map2, const double* sites1,
                 const double* sites2, const double* P1, const double* P2,
                 double* nodes, int32_t* out_m1, int32_t* out_m2,
                 uint8_t* out_matched) {
  BlasFns B{gemv_fn, ddot_fn, blas64, dim};
  std::vector<double> tmp(dim);
  int32_t out = 0;
  int32_t i1 = 0, i2 = 0;
#define EMIT(m1v, m2v, mv) \
  do { out_m1[out] = (m1v); out_m2[out] = (m2v); out_matched[out] = (mv); \
       ++out; } while (0)

  // unmatched g1 column i (merge: P1 @ g1[i]; incremental: copy)
  auto col1 = [&](int32_t i, double* v) {
    if (mode == 0) B.matvec(P1, sites1 + (int64_t)i * dim, v);
    else memcpy(v, sites1 + (int64_t)i * dim, dim * sizeof(double));
  };
  // unmatched / mapped-one-sided g2 column (merge unmatched: P1 quirk;
  // merge mapped one-sided: P2 — the Python fixup loop, folded in here;
  // incremental: P2)
  auto col2 = [&](int32_t i, const double* P, double* v) {
    B.matvec(P, sites2 + (int64_t)i * dim, v);
  };

  for (int32_t j = 0; j < nmap; ++j) {
    const int32_t k1 = map1[j];
    const int32_t k2 = map2[j];
    if (k1 != -1) {
      while (i1 != k1) {
        double* v = nodes + (int64_t)out * dim;
        col1(i1, v);
        norm_or_zero(B, v);
        EMIT(i1, -1, 0);
        ++i1;
      }
      ++i1;
    }
    if (k2 != -1) {
      while (i2 != k2) {
        double* v = nodes + (int64_t)out * dim;
        col2(i2, mode == 0 ? P1 : P2, v);
        norm_or_zero(B, v);
        EMIT(-1, i2, 0);
        ++i2;
      }
      ++i2;
    }
    double* v = nodes + (int64_t)out * dim;
    if (k1 != -1 && k2 != -1) {
      col1(k1, v);
      col2(k2, P2, tmp.data());
      for (int32_t k = 0; k < dim; ++k) v[k] *= tmp[k];
      norm_or_zero(B, v);
      EMIT(k1, k2, 1);
    } else if (k1 != -1) {
      col1(k1, v);
      norm_or_zero(B, v);
      EMIT(k1, -1, 1);
    } else if (k2 != -1) {
      col2(k2, P2, v);
      norm_or_zero(B, v);
      EMIT(-1, k2, 1);
    } else {
      return -1;  // "error in mapping"
    }
  }
#undef EMIT
  return out;
}

// ---------------------------------------------------------------------
// Fused per-node alignment: S precompute + M/X/Y/W fill + backtrack in ONE
// native call (the per-stage Python roundtrips — five numpy matrix
// allocations plus ~60 ctypes pointer conversions per node — cost more
// than the C compute itself on small guide-tree pairs).
// Scratch planes live in thread_local grow-only buffers so a level scheduler
// thread pays the allocation once.  Returns the emitted mapping length,
// -1 on backtrack failure (caller falls back to the staged path), with the
// alignment score in *wend.  Bit-identical by construction: it calls the
// exact same gc_precompute_scores / gc_fill_dp / gc_backtrack bodies.
int32_t gc_align_node(int32_t n1, int32_t n2, int32_t dim,
                      int32_t e1, int32_t e2,
                      const int32_t* idx1, const float* cost1,
                      const int32_t* idx2, const float* cost2,
                      const float* g1s, const float* g2s,
                      const float* Mm, const float* pi, float match_init,
                      float ge, float gi, float sg, float start_init,
                      float end_match, float end_gap, float end_skip,
                      int32_t* map1, int32_t* map2, float* wend) {
  static thread_local std::vector<float> Sb, Mb, Xb, Yb, Wb;
  size_t cells = (size_t)n1 * n2;
  if (Sb.size() < cells) {
    Sb.resize(cells); Mb.resize(cells); Xb.resize(cells);
    Yb.resize(cells); Wb.resize(cells);
  }
  gc_precompute_scores(n1, n2, dim, g1s, g2s, Mm, pi, match_init,
                       Sb.data());
  gc_fill_dp(n1, n2, e1, e2, idx1, cost1, idx2, cost2, Sb.data(), ge, gi,
             sg, start_init, end_match, end_gap, end_skip, Mb.data(),
             Xb.data(), Yb.data(), Wb.data(), wend);
  return gc_backtrack(n1, n2, e1, e2, idx1, cost1, idx2, cost2, Sb.data(),
                      Mb.data(), Xb.data(), Yb.data(), Wb.data(), *wend,
                      ge, gi, end_match, end_gap, end_skip, map1, map2);
}

// ---------------------------------------------------------------------
// Fused per-node merge: inverse mappings + edge construction + padded
// packing with ONE intermediate staging (thread-local) instead of six
// Python-side capacity arrays and three ctypes calls per node.  Two-call
// protocol because the padded width E is only known after construction:
//   E = gc_merge_node_begin(...)   computes edges into thread-local state
//   gc_merge_node_finish(n, E, ...) packs them into the caller's [n, E]
// Both calls MUST run on the same OS thread with no interleaved
// begin-call (the Python wrapper invokes them back to back).
static thread_local std::vector<int32_t> mn_eto, mn_efrom, mn_rto,
                                         mn_rfrom, mn_runits;
static thread_local std::vector<float> mn_ecost;
static thread_local int32_t mn_ne = 0, mn_nr = 0;

int32_t gc_merge_node_begin(
    int32_t n_nodes, const int32_t* m1, const int32_t* m2,
    const uint8_t* matched,
    int32_t g1n, int32_t g1E, const int32_t* idx1, const float* cost1,
    const uint8_t* isrep1, const int32_t* units1,
    int32_t g2n, int32_t g2E, const int32_t* idx2, const float* cost2,
    const uint8_t* isrep2, const int32_t* units2,
    float up1, float up2, int32_t with_penalty) {
  std::vector<int32_t> inv1((size_t)g1n, 0), inv2((size_t)g2n, 0);
  for (int32_t i = 0; i < n_nodes; ++i) {
    if (m1[i] != -1) inv1[m1[i]] = i;
    if (m2[i] != -1) inv2[m2[i]] = i;
  }
  size_t cap = (size_t)n_nodes * 4 + (size_t)g1n * g1E
             + (size_t)g2n * g2E + 16;
  if (mn_eto.size() < cap) {
    mn_eto.resize(cap); mn_efrom.resize(cap); mn_ecost.resize(cap);
    mn_rto.resize(cap); mn_rfrom.resize(cap); mn_runits.resize(cap);
  }
  merge_edges_impl(n_nodes, m1, m2, matched,
                   g1n, g1E, idx1, cost1, isrep1, units1, inv1.data(),
                   g2n, g2E, idx2, cost2, isrep2, units2, inv2.data(),
                   up1, up2, with_penalty,
                   mn_eto.data(), mn_efrom.data(), mn_ecost.data(), &mn_ne,
                   mn_rto.data(), mn_rfrom.data(), mn_runits.data(),
                   &mn_nr);
  std::vector<int32_t> cnt((size_t)n_nodes, 0);
  for (int32_t k = 0; k < mn_ne; ++k) ++cnt[mn_eto[k]];
  for (int32_t k = 0; k < mn_nr; ++k) ++cnt[mn_rto[k]];
  int32_t E = 1;
  for (int32_t i = 0; i < n_nodes; ++i) E = std::max(E, cnt[i]);
  return E;
}

void gc_merge_node_finish(int32_t n, int32_t E, int32_t* idx, float* cost,
                          uint8_t* isrep, int32_t* units) {
  gc_pad_edges(n, E, mn_ne, mn_eto.data(), mn_efrom.data(), mn_ecost.data(),
               mn_nr, mn_rto.data(), mn_rfrom.data(), mn_runits.data(),
               idx, cost, isrep, units);
}

}  // extern "C"
