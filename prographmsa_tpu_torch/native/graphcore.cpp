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
#include <atomic>
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

// f(c) for each entry c of a padded row of E with row[c] >= 0, in order.
// The leading run of such entries (every entry of the rows that
// Graph.padded() and padded_from_edges build) costs no branch per empty
// entry; any entry after the first empty one is found by one more scan.
template <typename F>
inline void each_edge(const int32_t* row, int32_t E, F&& f) {
  int32_t c = 0;
  for (; c < E && row[c] >= 0; ++c) f(c);
  bool stray = false;
  for (int32_t d = c; d < E; ++d) stray |= row[d] >= 0;
  if (stray)
    for (int32_t d = c; d < E; ++d)
      if (row[d] >= 0) f(d);
}

// dst [dst_rows, nmax] of a launch plane: dst[j, i] = src[i, j] (src
// [rows, cols] row-major, converted as a C cast: float64 to float32 rounds
// to nearest) for j < cols and i < rows, pad elsewhere.  Tiles of 32 rows
// keep the strided reads in cache.
template <typename S, typename D>
void transpose_pad(const S* src, int32_t rows, int32_t cols, D* dst,
                   int32_t dst_rows, int32_t nmax, D pad) {
  const int32_t T = 32;
  for (int32_t i0 = 0; i0 < rows; i0 += T) {
    const int32_t i1 = std::min(rows, i0 + T);
    for (int32_t j = 0; j < cols; ++j) {
      D* d = dst + (int64_t)j * nmax;
      const S* s = src + j;
      for (int32_t i = i0; i < i1; ++i) d[i] = (D)s[(int64_t)i * cols];
    }
  }
  for (int32_t j = 0; j < cols; ++j)
    std::fill(dst + (int64_t)j * nmax + rows, dst + (int64_t)(j + 1) * nmax,
              pad);
  std::fill(dst + (int64_t)cols * nmax, dst + (int64_t)dst_rows * nmax, pad);
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
// Prealigned pair statistics (distances/prealigned.py
// _pair_stats_batch_numpy; Prealigned.h:53-80): for each pair p of rows
// i = pi[p], j = pj[p] of the alignment vals / gaps [n_rows, L] (row-major,
// a nonzero flag is a gap), counts[p, v1, v2] over the columns where
// neither row is gapped and both values lie in [0, count_bound), and the
// gap openings gap_openings[p]: a column gapped in both rows is
// transparent; any other column's state is 0 (both residues), 2 (only row
// j gapped) or 3 (only row i gapped), and a run opens where the state is 2
// or 3 and differs from the previous non-transparent column's (0 before
// the first).  counts is [P, dim, dim], zero outside [0, count_bound)^2.
// Pairs are dealt to the threads in turn.  Returns -1, having written
// nothing, when a row index lies outside [0, n_rows).
int32_t gc_pair_stats(int32_t n_rows, int32_t L, const int32_t* vals,
                      const uint8_t* gaps, int64_t P, const int32_t* pi,
                      const int32_t* pj, int32_t count_bound, int32_t dim,
                      int64_t* counts, int64_t* gap_openings,
                      int32_t n_threads) {
  for (int64_t p = 0; p < P; ++p)
    if (pi[p] < 0 || pi[p] >= n_rows || pj[p] < 0 || pj[p] >= n_rows)
      return -1;
  if (n_threads < 1) n_threads = 1;
  if (n_threads > P) n_threads = (int32_t)std::max<int64_t>(P, 1);
  const uint32_t cb = (uint32_t)count_bound;
  const int64_t plane = (int64_t)dim * dim;

  auto work = [&](int32_t tid) {
    std::vector<int32_t> hist((size_t)cb * cb);
    for (int64_t p = tid; p < P; p += n_threads) {
      std::fill(hist.begin(), hist.end(), 0);
      const int32_t* a = vals + (int64_t)pi[p] * L;
      const int32_t* b = vals + (int64_t)pj[p] * L;
      const uint8_t* ga = gaps + (int64_t)pi[p] * L;
      const uint8_t* gb = gaps + (int64_t)pj[p] * L;
      int32_t prev = 0;
      int64_t opens = 0;
      for (int32_t c = 0; c < L; ++c) {
        const bool x = ga[c] != 0, y = gb[c] != 0;
        if (x && y) continue;
        if (!x && !y) {
          const uint32_t v1 = (uint32_t)a[c], v2 = (uint32_t)b[c];
          if (v1 < cb && v2 < cb) ++hist[v1 * cb + v2];
          prev = 0;
        } else {
          const int32_t s = x ? 3 : 2;
          opens += s != prev;
          prev = s;
        }
      }
      int64_t* out = counts + p * plane;
      std::memset(out, 0, sizeof(int64_t) * plane);
      for (uint32_t v1 = 0; v1 < cb; ++v1)
        for (uint32_t v2 = 0; v2 < cb; ++v2)
          out[v1 * dim + v2] = hist[v1 * cb + v2];
      gap_openings[p] = opens;
    }
  };

  if (n_threads == 1) {
    work(0);
  } else {
    std::vector<std::thread> ts;
    for (int32_t t = 0; t < n_threads; ++t) ts.emplace_back(work, t);
    for (auto& t : ts) t.join();
  }
  return 0;
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
namespace {
// One merged node's edges (the body of gc_merge_node_begin, also run by
// gc_merge_batch_begin): inverse mappings, then merge_edges_impl into the
// growing vectors; returns the padded width E (the largest row).
struct NodeEdges {
  std::vector<int32_t> eto, efrom, rto, rfrom, runits;
  std::vector<float> ecost;
  int32_t ne = 0, nr = 0;
};

int32_t node_edges(NodeEdges& s, int32_t n_nodes, const int32_t* m1,
                   const int32_t* m2, const uint8_t* matched,
                   int32_t g1n, int32_t g1E, const int32_t* idx1,
                   const float* cost1, const uint8_t* isrep1,
                   const int32_t* units1,
                   int32_t g2n, int32_t g2E, const int32_t* idx2,
                   const float* cost2, const uint8_t* isrep2,
                   const int32_t* units2,
                   float up1, float up2, int32_t with_penalty) {
  std::vector<int32_t> inv1((size_t)g1n, 0), inv2((size_t)g2n, 0);
  for (int32_t i = 0; i < n_nodes; ++i) {
    if (m1[i] != -1) inv1[m1[i]] = i;
    if (m2[i] != -1) inv2[m2[i]] = i;
  }
  size_t cap = (size_t)n_nodes * 4 + (size_t)g1n * g1E
             + (size_t)g2n * g2E + 16;
  if (s.eto.size() < cap) {
    s.eto.resize(cap); s.efrom.resize(cap); s.ecost.resize(cap);
    s.rto.resize(cap); s.rfrom.resize(cap); s.runits.resize(cap);
  }
  merge_edges_impl(n_nodes, m1, m2, matched,
                   g1n, g1E, idx1, cost1, isrep1, units1, inv1.data(),
                   g2n, g2E, idx2, cost2, isrep2, units2, inv2.data(),
                   up1, up2, with_penalty,
                   s.eto.data(), s.efrom.data(), s.ecost.data(), &s.ne,
                   s.rto.data(), s.rfrom.data(), s.runits.data(), &s.nr);
  std::vector<int32_t> cnt((size_t)n_nodes, 0);
  for (int32_t k = 0; k < s.ne; ++k) ++cnt[s.eto[k]];
  for (int32_t k = 0; k < s.nr; ++k) ++cnt[s.rto[k]];
  int32_t E = 1;
  for (int32_t i = 0; i < n_nodes; ++i) E = std::max(E, cnt[i]);
  return E;
}
}  // namespace

static thread_local NodeEdges mn_staged;

int32_t gc_merge_node_begin(
    int32_t n_nodes, const int32_t* m1, const int32_t* m2,
    const uint8_t* matched,
    int32_t g1n, int32_t g1E, const int32_t* idx1, const float* cost1,
    const uint8_t* isrep1, const int32_t* units1,
    int32_t g2n, int32_t g2E, const int32_t* idx2, const float* cost2,
    const uint8_t* isrep2, const int32_t* units2,
    float up1, float up2, int32_t with_penalty) {
  return node_edges(mn_staged, n_nodes, m1, m2, matched, g1n, g1E, idx1,
                    cost1, isrep1, units1, g2n, g2E, idx2, cost2, isrep2,
                    units2, up1, up2, with_penalty);
}

void gc_merge_node_finish(int32_t n, int32_t E, int32_t* idx, float* cost,
                          uint8_t* isrep, int32_t* units) {
  const NodeEdges& s = mn_staged;
  gc_pad_edges(n, E, s.ne, s.eto.data(), s.efrom.data(), s.ecost.data(),
               s.nr, s.rto.data(), s.rfrom.data(), s.runits.data(),
               idx, cost, isrep, units);
}

// ---------------------------------------------------------------------
// The angle distances' Gram (distances/angle.py compute_angle_distances):
// G[i, j] = sum over k of (inv_norm[i] * C[i, k]) * C[j, k], added in
// increasing k from 0.0, the products and the order of adds of the numpy
// path's cumulative sum over k.  Every term is >= +0.0, so a k with
// C[i, k] == 0 adds +0.0 and changes no value: it is skipped.  A row with
// no k-mers (inv_norm inf) is NaN throughout, inf * 0 as in numpy.
// counts [n, K] and G [n, n] are row-major.
void gc_angle_gram(int32_t n, int32_t K, const double* counts,
                   const double* inv_norm, double* G) {
  // The columns some row counts, transposed: ct[slot[k] * n + j] = C[j, k].
  std::vector<char> counted((size_t)K, 0);
  for (int32_t j = 0; j < n; ++j)
    for (int32_t k = 0; k < K; ++k)
      if (counts[(size_t)j * K + k] != 0.0) counted[k] = 1;
  std::vector<int32_t> slot((size_t)K, -1);
  int32_t used = 0;
  for (int32_t k = 0; k < K; ++k)
    if (counted[k]) slot[k] = used++;
  std::vector<double> ct((size_t)used * n);
  for (int32_t j = 0; j < n; ++j) {
    const double* row = counts + (size_t)j * K;
    for (int32_t k = 0; k < K; ++k)
      if (slot[k] >= 0) ct[(size_t)slot[k] * n + j] = row[k];
  }
  for (int32_t i = 0; i < n; ++i) {
    const double* row = counts + (size_t)i * K;
    double* __restrict g = G + (size_t)i * n;
    const double inv = inv_norm[i];
    if (!std::isfinite(inv)) {
      const double nan_term = inv * row[0];
      for (int32_t j = 0; j < n; ++j)
        g[j] = 0.0 + nan_term * counts[(size_t)j * K];
      continue;
    }
    for (int32_t j = 0; j < n; ++j) g[j] = 0.0;
    for (int32_t k = 0; k < K; ++k) {
      if (row[k] == 0.0) continue;
      const double s = inv * row[k];
      const double* __restrict c = ct.data() + (size_t)slot[k] * n;
      for (int32_t j = 0; j < n; ++j) g[j] = g[j] + s * c[j];
    }
  }
}

// ---------------------------------------------------------------------
// BioNJ (tree/nj.py build_nj_tree's loop, from dim = n down to 4).
namespace {
typedef double lanes4 __attribute__((vector_size(32)));
typedef int64_t mask4 __attribute__((vector_size(32)));

inline lanes4 load4(const double* p) {
  lanes4 x;
  std::memcpy(&x, p, sizeof x);
  return x;
}

// The end of one column's sum after its accumulators, acc's lanes 0-1 the
// first 2-wide packet accumulator and 2-3 the second.
inline double redux_end(lanes4 acc, const double* v, int32_t n, int32_t a,
                        int32_t end, int32_t end2) {
  double x0 = acc[0] + acc[2], x1 = acc[1] + acc[3];
  if (end > end2) {
    x0 = x0 + v[end2];
    x1 = x1 + v[end2 + 1];
  }
  double res = x0 + x1;
  for (int32_t i = 0; i < a; ++i) res = res + v[i];
  for (int32_t i = end; i < n; ++i) res = res + v[i];
  return res;
}

// Eigen's vectorised sum (eigen_compat._redux_contiguous) of each of the
// columns v + k * stride, k < count, of n doubles whose aligned body starts
// at a, into out[k * ostride]: two 2-wide accumulators over the body, their
// sum, the trailing packet, the lanes' sum, then the peeled head and the
// tail, each add in that order.  One 4-wide vector holds a column's two
// accumulators (the same adds, side by side), and four columns go at once
// so that their chains of adds overlap.
void redux_columns(const double* v, size_t stride, int32_t count, int32_t n,
                   int32_t a, double* out, int32_t ostride) {
  const int32_t body = n - a;
  const int32_t end = a + body / 2 * 2, end2 = a + body / 4 * 4;
  if (end - a <= 2) {
    for (int32_t k = 0; k < count; ++k) {
      const double* c = v + k * stride;
      double res = c[0];
      for (int32_t i = 1; i < n; ++i) res = res + c[i];
      out[k * ostride] = res;
    }
    return;
  }
  int32_t k = 0;
  for (; k + 4 <= count; k += 4) {
    const double* c0 = v + k * stride;
    const double *c1 = c0 + stride, *c2 = c1 + stride, *c3 = c2 + stride;
    lanes4 s0 = load4(c0 + a), s1 = load4(c1 + a), s2 = load4(c2 + a),
           s3 = load4(c3 + a);
    for (int32_t i = a + 4; i < end2; i += 4) {
      s0 = s0 + load4(c0 + i);
      s1 = s1 + load4(c1 + i);
      s2 = s2 + load4(c2 + i);
      s3 = s3 + load4(c3 + i);
    }
    out[k * ostride] = redux_end(s0, c0, n, a, end, end2);
    out[(k + 1) * ostride] = redux_end(s1, c1, n, a, end, end2);
    out[(k + 2) * ostride] = redux_end(s2, c2, n, a, end, end2);
    out[(k + 3) * ostride] = redux_end(s3, c3, n, a, end, end2);
  }
  for (; k < count; ++k) {
    const double* c = v + k * stride;
    lanes4 s0 = load4(c + a);
    for (int32_t i = a + 4; i < end2; i += 4) s0 = s0 + load4(c + i);
    out[k * ostride] = redux_end(s0, c, n, a, end, end2);
  }
}

// np.maximum(x, lo) for a number lo: a NaN x stays.
inline double at_least(double x, double lo) { return x < lo ? lo : x; }

// Column c of Q, 0.5 D[r, c] - coef (s_c + s_r) for r < n with +inf at
// r = c, into q; its least value into *m; whether it holds a NaN.  Without
// NaNs the least value does not depend on the order of the comparisons,
// so eight lanes compare side by side.
bool q_column(const double* col, const double* s, double sc, double coef,
              int32_t n, int32_t c, double* q, double* m) {
  const lanes4 half = {0.5, 0.5, 0.5, 0.5}, k = {coef, coef, coef, coef},
               scv = {sc, sc, sc, sc};
  const lanes4 inf = {INFINITY, INFINITY, INFINITY, INFINITY};
  const mask4 lane = {0, 1, 2, 3};
  lanes4 a = inf, b = inf;
  mask4 nan = {0, 0, 0, 0};
  int32_t r = 0;
  for (; r + 8 <= n; r += 8) {
    lanes4 x = half * load4(col + r) - k * (scv + load4(s + r));
    lanes4 y = half * load4(col + r + 4) - k * (scv + load4(s + r + 4));
    x = lane == (int64_t)(c - r) ? inf : x;
    y = lane == (int64_t)(c - r - 4) ? inf : y;
    std::memcpy(q + r, &x, sizeof x);
    std::memcpy(q + r + 4, &y, sizeof y);
    a = x < a ? x : a;
    b = y < b ? y : b;
    nan |= (x != x) | (y != y);
  }
  double least = INFINITY;
  bool any_nan = false;
  for (int j = 0; j < 4; ++j) {
    least = a[j] < least ? a[j] : least;
    least = b[j] < least ? b[j] : least;
    any_nan |= nan[j] != 0;
  }
  for (; r < n; ++r) {
    q[r] = r == c ? INFINITY : 0.5 * col[r] - coef * (sc + s[r]);
    least = q[r] < least ? q[r] : least;
    any_nan |= q[r] != q[r];
  }
  *m = least;
  return any_nan;
}
}  // namespace

// redux_columns over count columns of n doubles, one after another in v.
void gc_redux_sum(int32_t n, int32_t count, const double* v, int32_t a,
                  double* out) {
  redux_columns(v, n, count, n, a, out, 1);
}

// A per-thread work constant in place of every call's own (0: each
// call's own), for gc_bionj and the batch calls below (gc_batch_probe
// sets it).  Set and read by the calling thread only.
extern "C++" {
namespace {
int64_t g_grain = 0;
int32_t g_bionj_used = 0;  // the most threads gc_bionj ran on (a probe)

// Cells of D a thread of gc_bionj's team takes a step at the least: a
// part of a step costs the team some microseconds to hand over on an
// 8-core host, so below 2 x this many cells (a D of 363 rows) the team
// ends and the calling thread runs the last steps alone, and a call
// whose D is smaller (fam100's) has no team.  2^14 and 2^18 measured
// slower at 600 to 1,400 rows, and no grain faster at 400.
constexpr int64_t kBionjGrain = 1 << 16;
// Runs of columns a part of a step is cut into, for each thread of the
// team: a thread that the host takes off its core mid-step then holds up
// only the run it is in; the others take its runs left.
constexpr int32_t kRunsPerThread = 4;

// The first minimum of Q over a run of columns in column-major order, or
// the first NaN there (nan set): what the serial scan of those columns
// alone picks.  found is false when no value is below +inf.
struct QBest {
  double best = INFINITY;
  int32_t r = 0, c = 0;
  bool found = false, nan = false;
};

// One gc_bionj call: D's columns, V, and what each step hands on.  A step
// is three parts of O(dim^2) work cut into runs of columns (the column
// sums, the Q scan, the compaction; each run alike on any thread), and
// between them the parts of O(dim) work, in the numpy loop's order.
struct Bionj {
  static constexpr double MIN_DIST = 1e-4, MIN_VAR = 1e-5;
  int32_t n;
  const int32_t n_plan;
  const int32_t* plan;
  int32_t* join;
  double* len;
  std::vector<double> dt, var, sums, nd, nv;
  std::vector<int32_t> alive;
  std::vector<std::vector<double>> q, saved;  // per thread, per run
  std::vector<QBest> local;                    // per run of the Q scan
  int32_t dim, step = 0, i1 = 0, i2 = 0, runs = 1;

  Bionj(int32_t n_, const double* D, const double* V, int32_t n_plan_,
        const int32_t* plan_, int32_t* join_, double* len_, int32_t threads)
      : n(n_), n_plan(n_plan_), plan(plan_), join(join_), len(len_),
        dt((size_t)n_ * n_), var(V, V + (size_t)n_ * n_), sums(n_), nd(n_),
        nv(n_), alive(n_), q(threads, std::vector<double>(n_)),
        saved(threads * kRunsPerThread, std::vector<double>(n_)),
        local(threads * kRunsPerThread), dim(n_) {
    for (int32_t r = 0; r < n; ++r)
      for (int32_t c = 0; c < n; ++c)
        dt[(size_t)c * n + r] = at_least(D[(size_t)r * n + c], MIN_DIST);
    for (size_t k = 0; k < var.size(); ++k)
      var[k] = at_least(var[k], MIN_VAR);
    for (int32_t r = 0; r < n; ++r) {
      dt[(size_t)r * n + r] = 0.0;
      var[(size_t)r * n + r] = 0.0;
      alive[r] = r;
    }
  }

  // Run k's columns of `count` columns, for this step's number of runs.
  int32_t lo(int32_t k, int32_t count) const {
    return (int32_t)((int64_t)count * k / runs);
  }
  int32_t hi(int32_t k, int32_t count) const { return lo(k + 1, count); }

  // Run k: the column sums of its columns (eigen_colwise_sum: an odd
  // column of an odd dim starts unaligned), and a copy of the column past
  // its run of the compaction, which the next run overwrites.
  void sum_run(int32_t k) {
    const int32_t a = lo(k, dim), b = hi(k, dim);
    if (dim % 2 == 0) {
      redux_columns(dt.data() + (size_t)a * n, n, b - a, dim, 0,
                    sums.data() + a, 1);
    } else {
      const int32_t e = a + (a & 1), o = a + !(a & 1);
      if (b > e)
        redux_columns(dt.data() + (size_t)e * n, 2 * (size_t)n,
                      (b - e + 1) / 2, dim, 0, sums.data() + e, 2);
      if (b > o)
        redux_columns(dt.data() + (size_t)o * n, 2 * (size_t)n,
                      (b - o + 1) / 2, dim, 1, sums.data() + o, 2);
    }
    const int32_t c = hi(k, dim - 1);
    if (c > lo(k, dim - 1))
      std::memcpy(saved[k].data(), dt.data() + (size_t)c * n,
                  sizeof(double) * dim);
  }

  // Run k, on thread t's scratch: Q = 0.5 D - 0.5 / (dim - 2) (s_c +
  // s_r), diagonal +inf, over its columns: the serial scan's pick among
  // them.
  void q_run(int32_t k, int32_t t) {
    const double coef = 0.5 / (dim - 2.0);
    QBest& L = local[k];
    L = QBest();
    const double* qc = q[t].data();
    for (int32_t c = lo(k, dim), e = hi(k, dim); c < e; ++c) {
      double m;
      if (q_column(dt.data() + (size_t)c * n, sums.data(), sums[c], coef,
                   dim, c, q[t].data(), &m)) {
        int32_t r = 0;
        while (qc[r] == qc[r]) ++r;
        L.r = r;
        L.c = c;
        L.nan = true;
        return;
      }
      if (m < L.best) {
        int32_t r = 0;
        while (!(qc[r] == m)) ++r;
        L.best = m;
        L.r = r;
        L.c = c;
        L.found = true;
      }
    }
  }

  // The step's pair (the plan's, or the first minimum of Q in
  // column-major order from the runs' picks in column order, a NaN
  // winning as np.argmin's does), its branch lengths, lambda and the new
  // node's row of D and of V.  False for a plan's pair that is no pair.
  bool pick() {
    if (step < n_plan) {
      i1 = plan[2 * step];
      i2 = plan[2 * step + 1];
      if (i1 < 0 || i2 <= i1 || i2 >= dim) return false;
    } else {
      double best = INFINITY;
      int32_t br = 0, bc = 0;
      for (int32_t k = 0; k < runs; ++k) {
        const QBest& L = local[k];
        if (L.nan) {
          br = L.r;
          bc = L.c;
          break;
        }
        if (L.found && L.best < best) {
          best = L.best;
          br = L.r;
          bc = L.c;
        }
      }
      i1 = std::min(br, bc);
      i2 = std::max(br, bc);
    }

    // Python's max(a, b) is b if b > a else a, min(a, b) b if b < a else a.
    const double d12 = dt[(size_t)i2 * n + i1], d21 = dt[(size_t)i1 * n + i2];
    double dist1 = (d12 + (sums[i1] - sums[i2]) / (dim - 2.0)) / 2.0;
    dist1 = MIN_DIST > dist1 ? MIN_DIST : dist1;
    dist1 = d12 < dist1 ? d12 : dist1;
    double dist2 = d21 - dist1;
    dist2 = MIN_DIST > dist2 ? MIN_DIST : dist2;

    const int32_t p1 = alive[i1], p2 = alive[i2];
    const double* v1 = var.data() + (size_t)p1 * n;
    const double* v2 = var.data() + (size_t)p2 * n;
    double acc = v2[alive[0]] - v1[alive[0]];
    for (int32_t j = 1; j < dim; ++j)
      acc = acc + (v2[alive[j]] - v1[alive[j]]);
    const double v12 = v1[p2];
    double lam = 0.5 + acc / (2.0 * (dim - 2) * v12);
    if (lam != lam) {
      lam = 0.5;
    } else {
      lam = lam > 0.0 ? lam : 0.0;
      lam = 1.0 < lam ? 1.0 : lam;
    }
    const double mu = 1.0 - lam, w = lam * mu * v12;
    for (int32_t j = 0; j < dim; ++j) {
      nd[j] = lam * (dt[(size_t)j * n + i1] - dist1)
              + mu * (dt[(size_t)j * n + i2] - dist2);
      nv[j] = lam * v1[alive[j]] + mu * v2[alive[j]] - w;
    }
    nd[i1] = 0.0;
    nv[i1] = 0.0;
    join[2 * step] = i1;
    join[2 * step + 1] = i2;
    len[2 * step] = dist1;
    len[2 * step + 1] = dist2;
    return true;
  }

  // Run k: row i2 goes from its columns, and column i2 from D, each of
  // its columns past i2 taking the next one's rows (the last from the copy
  // sum_run made, which the next run's first column has overwritten).
  void compact_run(int32_t k) {
    const int32_t tail = dim - 1 - i2, e = hi(k, dim - 1);
    for (int32_t c = lo(k, dim - 1); c < e; ++c) {
      double* dst = dt.data() + (size_t)c * n;
      if (c < i2) {
        std::memmove(dst + i2, dst + i2 + 1, sizeof(double) * tail);
        continue;
      }
      const double* src = c + 1 == e ? saved[k].data() : dst + n;
      std::memcpy(dst, src, sizeof(double) * i2);
      std::memcpy(dst + i2, src + i2 + 1, sizeof(double) * tail);
    }
  }

  // After a step: the new node's row and column take i1.  Where a step
  // follows, they take them as its np.maximum and zeroed diagonals leave
  // them (the only new entries it would change), so the row and column
  // are walked once; the 3 x 3 D of the last step keeps them raw.
  void finish() {
    const int32_t tail = dim - 1 - i2, p1 = alive[i1];
    std::memmove(nd.data() + i2, nd.data() + i2 + 1, sizeof(double) * tail);
    std::memmove(nv.data() + i2, nv.data() + i2 + 1, sizeof(double) * tail);
    alive.erase(alive.begin() + i2);
    --dim;
    ++step;
    const bool next = dim > 3;
    for (int32_t j = 0; j < dim; ++j) {
      const double d = next ? at_least(nd[j], MIN_DIST) : nd[j];
      const double v = next ? at_least(nv[j], MIN_VAR) : nv[j];
      dt[(size_t)j * n + i1] = d;
      dt[(size_t)i1 * n + j] = d;
      var[(size_t)p1 * n + alive[j]] = v;
      var[(size_t)alive[j] * n + p1] = v;
    }
    if (next) {
      dt[(size_t)i1 * n + i1] = 0.0;
      var[(size_t)p1 * n + p1] = 0.0;
    }
  }

  // One step on the calling thread alone.  False for a plan's bad pair.
  bool serial_step() {
    runs = 1;
    sum_run(0);
    if (step >= n_plan) q_run(0, 0);
    if (!pick()) return false;
    compact_run(0);
    finish();
    return true;
  }
};

// The team's parts of a step.  A part is published as one word,
// generation << 32 | runs; thread t claims its own runs first (the block
// t * kRunsPerThread ..., so each thread keeps its columns in its own
// cache from part to part), then any run still unclaimed.  A run is
// claimed by raising its flag from an earlier generation to the part's,
// so a thread late from an earlier part can claim nothing.  The thread
// that completes a part's last run does the O(dim) work after it and
// publishes the next part (or the end): no thread waits for a given one,
// only for runs that are claimed, so a thread the host takes off its core
// holds up at most the run it is in.
class BionjTeam {
 public:
  enum Part { kSums, kQ, kCompact };

  BionjTeam(Bionj& S, int32_t threads, int64_t grain, int32_t n_threads)
      : S_(S), T_(threads), grain_(grain), n_threads_(n_threads),
        flags_(threads) {
    for (auto& f : flags_)
      for (auto& g : f.run) g.store(0, std::memory_order_relaxed);
  }

  // Runs the steps while the team is wanted; false for a plan's bad pair.
  bool run() {
    publish(kSums);
    std::vector<std::thread> ts;
    for (int32_t t = 1; t < T_; ++t) ts.emplace_back([this, t] { work(t); });
    work(0);
    for (auto& t : ts) t.join();
    return ok_;
  }

 private:
  void publish(Part part) {
    S_.runs = T_ * kRunsPerThread;
    part_ = part;
    done_.store(0, std::memory_order_relaxed);
    gen_ += 1;
    word_.store(gen_ << 32 | (uint64_t)S_.runs, std::memory_order_release);
  }

  void end() { ended_.store(true, std::memory_order_release); }

  // After the last run of a part: the O(dim) work, then the next part.
  void after(Part part) {
    if (part == kSums && S_.step >= S_.n_plan) return publish(kQ);
    if (part != kCompact) {
      if (!S_.pick()) {
        ok_ = false;
        return end();
      }
      return publish(kCompact);
    }
    S_.finish();
    const int64_t cells = (int64_t)S_.dim * S_.dim;
    if (S_.dim <= 3 || std::min<int64_t>(n_threads_, cells / grain_) < 2)
      return end();
    publish(kSums);
  }

  // Claims run k for generation gen: true if this thread raised its flag.
  bool claim(int32_t k, uint64_t gen) {
    std::atomic<uint64_t>& f = flags_[k / kRunsPerThread].run[k % kRunsPerThread];
    uint64_t was = f.load(std::memory_order_relaxed);
    return was < gen && f.compare_exchange_strong(was, gen,
                                                  std::memory_order_acq_rel);
  }

  void work(int32_t t) {
    uint64_t seen = 0;  // the last generation this thread worked on
    for (int32_t spins = 0;;) {
      if (ended_.load(std::memory_order_acquire)) return;
      const uint64_t w = word_.load(std::memory_order_acquire);
      const uint64_t gen = w >> 32;
      if (gen == seen) {
        if (++spins > 256) std::this_thread::yield();
        continue;
      }
      spins = 0;
      seen = gen;
      const int32_t runs = (int32_t)(w & 0xffffffffu);
      int32_t mine = 0;  // runs done, counted once when none is left
      Part part = kSums;
      for (int32_t i = 0; i < runs; ++i) {
        const int32_t k = (t * kRunsPerThread + i) % runs;
        if (!claim(k, gen)) continue;
        part = part_;
        if (part == kSums) S_.sum_run(k);
        else if (part == kQ) S_.q_run(k, t);
        else S_.compact_run(k);
        ++mine;
      }
      if (mine && done_.fetch_add(mine, std::memory_order_acq_rel) + mine
                      == runs)
        after(part);
    }
  }

  Bionj& S_;
  const int32_t T_;
  const int64_t grain_;
  const int32_t n_threads_;
  struct alignas(64) Flags {   // a thread's own runs, a cache line each
    std::atomic<uint64_t> run[kRunsPerThread];
  };
  std::vector<Flags> flags_;   // per run: the generation that claimed it
  alignas(64) std::atomic<uint64_t> word_{0};
  alignas(64) std::atomic<int32_t> done_{0};
  alignas(64) std::atomic<bool> ended_{false};
  uint64_t gen_ = 0;     // written by the publishing thread only
  Part part_ = kSums;    // published with word_
  bool ok_ = true;
};
}  // namespace
}  // extern "C++"

// D and V are [n, n] row-major, n > 3, and are not written.  Step t joins
// the current rows join[2t] < join[2t + 1] with branch lengths len[2t],
// len[2t + 1]; the first n_plan steps take plan's pairs in place of the
// Q matrix's minimum.  The 3 x 3 D left at the end goes to d_end.  Every
// operation of the numpy loop is kept, in its order (the library is built
// with -ffp-contract=off), so the joins and lengths are its bits: NJ breaks
// ties on the last bit.  Returns 0, or -1 for a plan's pair that is no
// pair of the current rows.
//
// Layout: dt holds D's columns as rows (dt[c * n + r] = D[r, c], the
// column sums and the column-major minimum run along them), compacted in
// place when a row and column go, so that the current rows stay in the
// numpy order the sums depend on.  V is only read and written by row and
// column, so it keeps its places and `alive` maps a current row to one.
//
// The O(dim^2) parts of a step (the column sums, the Q scan, the
// compaction) are cut into runs of columns that a team of up to
// n_threads threads claims (BionjTeam; the team lives for the call and
// holds no Python lock).  Each column's sum and Q column is the serial
// loop's, and the runs' picks are reduced in column order, so the result
// does not depend on the team.  The team has a thread for each
// kBionjGrain cells of D (the grain gc_batch_probe sets, where set) and
// ends once a step has fewer than two threads' cells; the calling thread
// runs the steps left.
int32_t gc_bionj(int32_t n, const double* D, const double* V,
                 int32_t n_plan, const int32_t* plan, int32_t* join,
                 double* len, double* d_end, int32_t n_threads) {
  const int64_t grain = g_grain > 0 ? g_grain : kBionjGrain;
  const int32_t T = (int32_t)std::max<int64_t>(
      1, std::min<int64_t>(n_threads, (int64_t)n * n / grain));
  g_bionj_used = std::max(g_bionj_used, T);
  Bionj S(n, D, V, n_plan, plan, join, len, T);
  if (T > 1 && !BionjTeam(S, T, grain, n_threads).run()) return -1;
  while (S.dim > 3)
    if (!S.serial_step()) return -1;
  for (int32_t r = 0; r < 3; ++r)
    for (int32_t c = 0; c < 3; ++c)
      d_end[r * 3 + c] = S.dt[(size_t)c * n + r];
  return 0;
}

// The most threads gc_bionj ran on since the last call, the count then
// started anew.
int32_t gc_bionj_probe() {
  const int32_t used = g_bionj_used;
  g_bionj_used = 0;
  return used;
}

// ---------------------------------------------------------------------
// Offset slots of one graph for the device DP batch (align/slots.py
// _offset_costs_rep_numpy): the distinct offsets i - idx[i, c] of the
// graph's repeat edges ascending, then those of its normal edges
// ascending, written to offsets; the number of repeat slots to *n_rep.
// Every repeat edge makes a slot, a NaN-cost one too.  Returns the number
// of slots, or -1 when it exceeds max_offsets (an offset used by both
// kinds counts twice).  offsets has room for min(max_offsets, n * E).
// Offsets are marked in a table over their range, one byte per offset
// and kind.
int32_t gc_offset_slots(int32_t n, int32_t E, const int32_t* idx,
                        const uint8_t* isrep, int32_t max_offsets,
                        int32_t* offsets, int32_t* n_rep) {
  std::vector<int64_t> offs;   // each edge's offset; a repeat edge's + 2^40
  offs.reserve((size_t)n * 2);
  int64_t lo = INT64_MAX, hi = INT64_MIN;
  for (int32_t i = 0; i < n; ++i) {
    const int32_t* row = idx + (int64_t)i * E;
    const uint8_t* rrow = isrep + (int64_t)i * E;
    each_edge(row, E, [&](int32_t c) {
      const int64_t off = (int64_t)i - row[c];
      lo = std::min(lo, off);
      hi = std::max(hi, off);
      offs.push_back(off + (rrow[c] ? (int64_t)1 << 40 : 0));
    });
  }
  *n_rep = 0;
  if (offs.empty()) return max_offsets < 0 ? -1 : 0;
  const int64_t range = hi - lo + 1;
  std::vector<uint8_t> mark(2 * range, 0);   // [repeat | normal]
  for (const int64_t o : offs)
    mark[o >= (int64_t)1 << 39 ? o - ((int64_t)1 << 40) - lo
                               : range + o - lo] = 1;
  int32_t count = 0;
  for (int64_t q = 0; q < 2 * range; ++q) count += mark[q];
  if (count > max_offsets) return -1;
  int32_t k = 0;
  for (int64_t q = 0; q < 2 * range; ++q) {
    if (!mark[q]) continue;
    offsets[k++] = (int32_t)(lo + (q < range ? q : q - range));
    *n_rep += q < range;
  }
  return count;
}

// Slot cost tables of one graph (align/slots.py _offset_costs_rep_numpy)
// on the count slots of gc_offset_slots (n_rep repeat slots first):
// C [n, m] float32, m = max(count, 1), starts at +inf; each edge into node
// i, in row-major padded order (the PredIterator order), lowers its slot's
// cell with a strict < (the first of equal values stays, so 0.0 before
// -0.0 keeps 0.0; a NaN never wins).  A normal edge brings its cost, a
// repeat edge ri + re * (units - 1) in float32 (no FMA: the file builds
// with -ffp-contract=off); a repeat edge of NaN cost is skipped, any other
// sets rep [n, m] (uint8) at its cell whether or not it won.  With cap,
// every non-finite cell then becomes cap_value (slots.inf_to_cap).
// Returns count, or -1 when an edge's offset is in no slot of its kind or
// the slots of a kind are not strictly ascending.
int32_t gc_offset_costs(int32_t n, int32_t E, const int32_t* idx,
                        const float* cost, const uint8_t* isrep,
                        const int32_t* units, float ri, float re,
                        int32_t count, int32_t n_rep, const int32_t* offsets,
                        int32_t cap, float cap_value, float* C,
                        uint8_t* rep) {
  const int32_t m = std::max(count, 1);
  // slot of each offset, per kind, over the slots' range (-1: none)
  int64_t lo[2] = {0, 0}, range[2] = {0, 0};
  std::vector<int32_t> slot[2];
  const int32_t first[2] = {0, n_rep}, last[2] = {n_rep, count};
  for (int kind = 0; kind < 2; ++kind) {
    if (first[kind] == last[kind]) continue;
    for (int32_t k = first[kind] + 1; k < last[kind]; ++k)
      if (offsets[k] <= offsets[k - 1]) return -1;
    lo[kind] = offsets[first[kind]];
    range[kind] = (int64_t)offsets[last[kind] - 1] - lo[kind] + 1;
    slot[kind].assign(range[kind], -1);
    for (int32_t k = first[kind]; k < last[kind]; ++k)
      slot[kind][offsets[k] - lo[kind]] = k;
  }
  std::fill(C, C + (int64_t)n * m, INFINITY);
  std::memset(rep, 0, (size_t)n * m);
  bool missing = false;
  for (int32_t i = 0; i < n && !missing; ++i) {
    float* crow = C + (int64_t)i * m;
    uint8_t* rrow = rep + (int64_t)i * m;
    each_edge(idx + (int64_t)i * E, E, [&](int32_t c) {
      const int64_t e = (int64_t)i * E + c;
      const int kind = isrep[e] ? 0 : 1;
      const int64_t q = (int64_t)i - idx[e] - lo[kind];
      if (q < 0 || q >= range[kind] || slot[kind][q] < 0) {
        missing = true;
        return;
      }
      const int32_t k = slot[kind][q];
      float v = cost[e];
      if (kind == 0) {
        const int32_t u1 = (int32_t)((uint32_t)units[e] - 1u);
        v = ri + re * (float)u1;
        if (std::isnan(v)) return;
        rrow[k] = 1;
      }
      crow[k] = v < crow[k] ? v : crow[k];
    });
  }
  if (cap)
    for (int64_t q = 0; q < (int64_t)n * m; ++q)
      C[q] = std::isfinite(C[q]) ? C[q] : cap_value;
  return missing ? -1 : count;
}

// The large planes of one launch of the device DP batch
// (align/graph_dp_cuda.py _planes_numpy).  Pair b has sides[b] = (a1, a2,
// k1, k2): nodes and slots of its two graphs, and ptrs[b] = addresses of
// (sites1 [a1, dim] float64, sites2, C1 [a1, k1] float32, C2, rep1
// [a1, k1] uint8, rep2).  It writes g1T[b] [dim, n1max] (the sites rounded
// to float32, transposed, zero past a1), C1T[b] [opmax, n1max] (cap_value
// outside C1's transpose), R1T[b] [opmax, n1max] (zero outside), the same
// for side 2 at n2max, and finite[b] = the number of entries below
// cap_value in C1 and in C2.  Pairs are dealt to the threads in turn, at
// most one thread for each 2^18 plane entries (a thread's start costs
// about as much as writing that many).
void gc_pack_planes(int32_t B, int32_t dim, int32_t n1max, int32_t n2max,
                    int32_t opmax, const int32_t* sides, const int64_t* ptrs,
                    float cap_value, float* g1T, float* g2T, float* C1T,
                    float* C2T, uint8_t* R1T, uint8_t* R2T, int64_t* finite,
                    int32_t n_threads) {
  const int64_t entries = (int64_t)B * (dim + 2 * opmax) * (n1max + n2max);
  n_threads = (int32_t)std::min<int64_t>(n_threads, entries >> 18);
  if (n_threads > B) n_threads = B;
  if (n_threads < 1) n_threads = 1;
  auto side = [&](int32_t b, int32_t s, int32_t nmax, float* gT, float* CT,
                  uint8_t* RT) {
    const int32_t a = sides[4 * b + s], k = sides[4 * b + 2 + s];
    const double* sites = (const double*)(intptr_t)ptrs[6 * b + s];
    const float* c = (const float*)(intptr_t)ptrs[6 * b + 2 + s];
    const uint8_t* r = (const uint8_t*)(intptr_t)ptrs[6 * b + 4 + s];
    transpose_pad(sites, a, dim, gT + (int64_t)b * dim * nmax, dim, nmax,
                  0.0f);
    transpose_pad(c, a, k, CT + (int64_t)b * opmax * nmax, opmax, nmax,
                  cap_value);
    transpose_pad(r, a, k, RT + (int64_t)b * opmax * nmax, opmax, nmax,
                  (uint8_t)0);
    int64_t f = 0;
    for (int64_t q = 0; q < (int64_t)a * k; ++q) f += c[q] < cap_value;
    finite[2 * b + s] = f;
  };
  auto work = [&](int32_t tid) {
    for (int32_t b = tid; b < B; b += n_threads) {
      side(b, 0, n1max, g1T, C1T, R1T);
      side(b, 1, n2max, g2T, C2T, R2T);
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
// A level's host stage in batches (engine/level_driver.py align_tasks):
// the cleaning of every graph, the host alignment of every pair, the merge
// of every node and its row block, each in one call that spreads the items
// over std::threads and holds no Python lock.  Items are handed out from a
// shared counter: within a level, node sizes differ by 100x.  Where an
// output's size is known only after the work, the call has two phases:
// gc_*_begin does the work into a staged batch and writes each item's
// sizes, the caller allocates arrays of exactly those sizes, gc_*_finish
// copies into them; gc_batch_free frees the staged batch (after finish, or
// in its place on an error).  Each item's work is the single-item body
// that the per-node path runs, so the results are the same bit for bit.
extern "C++" {
namespace {
struct Staged {
  virtual ~Staged() {}
};

// f(k) for k in [0, n) on up to n_threads threads (the calling thread
// one of them); false when an item threw (bad_alloc), which is then
// reported instead of ending the process.
template <typename F>
bool for_each_item(int32_t n, int32_t n_threads, F&& f) {
  std::atomic<int32_t> next{0};
  std::atomic<bool> ok{true};
  auto work = [&]() {
    for (int32_t k; (k = next.fetch_add(1)) < n;) {
      try {
        f(k);
      } catch (...) {
        ok = false;
      }
    }
  };
  n_threads = std::max(1, std::min(n_threads, n));
  std::vector<std::thread> ts;
  for (int32_t t = 1; t < n_threads; ++t) ts.emplace_back(work);
  work();
  for (auto& t : ts) t.join();
  return ok;
}

// The kinds of batch call, in the order gc_batch_probe reports them.
enum BatchKind {
  kCleanBegin, kCleanFinish, kAlign, kMergeBegin, kMergeFinish, kExtend,
  kBatchKinds
};

// The most threads each kind of call ran on since the last
// gc_batch_probe (g_grain above is the work constant it sets).  Set and
// read by the calling thread only.
int32_t g_used[kBatchKinds] = {};

// The threads for a batch of ``items`` items and ``work`` units: at most
// one for each ``per_thread`` units and one an item, at least one.  A
// thread's start and join cost about 0.2 ms on an 8-core host, so each
// constant below is about 2 ms of its call's work a thread; a level of
// small nodes then runs on the calling thread alone.
int32_t threads_for(BatchKind kind, int32_t items, int64_t work,
                    int64_t per_thread, int32_t n_threads) {
  if (g_grain > 0) per_thread = g_grain;
  const int32_t t = (int32_t)std::max<int64_t>(
      1, std::min<int64_t>({n_threads, items, work / per_thread}));
  g_used[kind] = std::max(g_used[kind], t);
  return t;
}

// A thread's scratch of at least n elements, grown only (a capacity
// buffer touched once a thread, not once an item); an item's staged
// output then keeps only the exact entries.
template <typename T>
T* scratch(std::vector<T>& v, size_t n) {
  if (v.size() < n) v.resize(n);
  return v.data();
}

template <typename T>
inline const T* at(const int64_t* ptrs, int64_t k) {
  return (const T*)(intptr_t)ptrs[k];
}

// --- cleaning (graph/graph.py clean_graph) ---------------------------
struct CleanItem {
  int32_t n = 0, dim = 0;
  const double* sites = nullptr;
  std::vector<int32_t> mapping, eto, efrom, rto, rfrom, runits;
  std::vector<float> ecost;
  int32_t ne = 0, nr = 0;
};
struct CleanBatch : Staged {
  std::vector<CleanItem> items;
};

// The linear-chain fast path of clean_graph: one slot a row, no repeat
// slot, row i's predecessor i - 1, every cost after row 0 finite.
bool linear_chain(int32_t n, int32_t E, const int32_t* idx, const float* cost,
                  const uint8_t* isrep) {
  if (E != 1) return false;
  for (int32_t i = 0; i < n; ++i)
    if (isrep[i] || idx[i] != i - 1) return false;
  for (int32_t i = 1; i < n; ++i)
    if (!std::isfinite(cost[i])) return false;
  return true;
}
}  // namespace
}  // extern "C++"

// Graph b has dims[3b..] = (n, E, dim) and ptrs[5b..] = (idx [n, E]
// int32, cost float32, isrep uint8, units int32, sites [n, dim] float64).
// Writes sizes[3b..] = (status, new_dim, E'): status 1 for a linear chain
// (cleaned to itself: the caller keeps the graph), 0 for a cleaned graph
// of new_dim nodes and padded width E', -1 when the start/end
// reachability invariant fails.  Returns the staged batch, or null when
// an item could not allocate.
void* gc_clean_batch_begin(int32_t B, const int32_t* dims,
                           const int64_t* ptrs, float repeat_ext,
                           int32_t* sizes, int32_t n_threads) {
  CleanBatch* cb = new CleanBatch();
  cb->items.resize(B);
  int64_t work = 0;
  for (int32_t b = 0; b < B; ++b)
    work += (int64_t)dims[3 * b] * dims[3 * b + 1];
  n_threads = threads_for(kCleanBegin, B, work, 1 << 19, n_threads);
  bool ok = for_each_item(B, n_threads, [&](int32_t b) {
    const int32_t n = dims[3 * b], E = dims[3 * b + 1];
    const int32_t* idx = at<int32_t>(ptrs, 5 * b);
    const float* cost = at<float>(ptrs, 5 * b + 1);
    const uint8_t* isrep = at<uint8_t>(ptrs, 5 * b + 2);
    const int32_t* units = at<int32_t>(ptrs, 5 * b + 3);
    CleanItem& it = cb->items[b];
    if (linear_chain(n, E, idx, cost, isrep)) {
      sizes[3 * b] = 1;
      sizes[3 * b + 1] = n;
      sizes[3 * b + 2] = 1;
      return;
    }
    it.n = n;
    it.dim = dims[3 * b + 2];
    it.sites = at<double>(ptrs, 5 * b + 4);
    const size_t cap = (size_t)n * E;
    static thread_local std::vector<int32_t> eto, efrom, rto, rfrom, runits;
    static thread_local std::vector<float> ecost;
    it.mapping.resize(n);
    const int32_t new_dim = gc_clean_graph(
        n, E, idx, cost, isrep, units, repeat_ext, it.mapping.data(),
        scratch(eto, cap), scratch(efrom, cap), scratch(ecost, cap), &it.ne,
        scratch(rto, cap), scratch(rfrom, cap), scratch(runits, cap), &it.nr);
    sizes[3 * b] = new_dim < 0 ? -1 : 0;
    sizes[3 * b + 1] = new_dim;
    if (new_dim < 0) {
      sizes[3 * b + 2] = 0;
      return;
    }
    it.eto.assign(eto.begin(), eto.begin() + it.ne);
    it.efrom.assign(efrom.begin(), efrom.begin() + it.ne);
    it.ecost.assign(ecost.begin(), ecost.begin() + it.ne);
    it.rto.assign(rto.begin(), rto.begin() + it.nr);
    it.rfrom.assign(rfrom.begin(), rfrom.begin() + it.nr);
    it.runits.assign(runits.begin(), runits.begin() + it.nr);
    sizes[3 * b + 2] = gc_edge_span(new_dim, it.ne, it.eto.data(), it.nr,
                                    it.rto.data());
  });
  if (!ok) {
    delete cb;
    return nullptr;
  }
  return cb;
}

// Fills each graph of status 0: out[6b..] = (sites [new_dim, dim] float64:
// the kept rows in their order, outmapping [new_dim] int64: their old
// indices, then idx, cost, isrep, units [new_dim, E'] as gc_pad_edges
// packs them).  Returns 0, or -1 when an item could not allocate.
int32_t gc_clean_batch_finish(void* staged, const int32_t* sizes,
                              const int64_t* out, int32_t n_threads) {
  CleanBatch* cb = (CleanBatch*)staged;
  const int32_t B = (int32_t)cb->items.size();
  int64_t work = 0;
  for (int32_t b = 0; b < B; ++b)
    if (sizes[3 * b] == 0)
      work += (int64_t)sizes[3 * b + 1]
              * (cb->items[b].dim + sizes[3 * b + 2]);
  n_threads = threads_for(kCleanFinish, B, work, 1 << 18, n_threads);
  bool ok = for_each_item(B, n_threads, [&](int32_t b) {
    if (sizes[3 * b] != 0) return;
    const CleanItem& it = cb->items[b];
    const int32_t nd = sizes[3 * b + 1], E = sizes[3 * b + 2];
    double* sites = (double*)(intptr_t)out[6 * b];
    int64_t* outmap = (int64_t*)(intptr_t)out[6 * b + 1];
    for (int32_t to = 0; to < it.n; ++to) {
      const int32_t y = it.mapping[to];
      if (y == -1) continue;
      memcpy(sites + (int64_t)y * it.dim, it.sites + (int64_t)to * it.dim,
             it.dim * sizeof(double));
      outmap[y] = to;
    }
    gc_pad_edges(nd, E, it.ne, it.eto.data(), it.efrom.data(),
                 it.ecost.data(), it.nr, it.rto.data(), it.rfrom.data(),
                 it.runits.data(), (int32_t*)(intptr_t)out[6 * b + 2],
                 (float*)(intptr_t)out[6 * b + 3],
                 (uint8_t*)(intptr_t)out[6 * b + 4],
                 (int32_t*)(intptr_t)out[6 * b + 5]);
  });
  return ok ? 0 : -1;
}

void gc_batch_free(void* staged) { delete (Staged*)staged; }

// Writes the most threads each kind of batch call ran on since the last
// probe into used[6] (clean begin, clean finish, align, merge begin, merge
// finish, extend) and starts a new count; from now on every call gives a
// thread ``grain`` units of work in place of its own constant (0: its
// own).  The tests lower the grain so that small inputs run the threaded
// paths.
void gc_batch_probe(int64_t grain, int32_t* used) {
  for (int32_t k = 0; k < kBatchKinds; ++k) {
    used[k] = g_used[k];
    g_used[k] = 0;
  }
  g_grain = grain;
}

// --- host alignments (native.align_node_native) ----------------------
namespace {
struct AlignBatch : Staged {
  std::vector<std::vector<int32_t>> map1, map2;
};
}  // namespace

// Pair b has dims[5b..] = (n1, n2, E1, E2, dim), ptrs[10b..] = (idx1
// [n1, E1] int32, cost1 float32, isrep1 uint8, idx2, cost2, isrep2,
// sites1 [n1, dim] float64, sites2, M [dim, dim] float64, pi [dim]
// float64) and scal[8b..] = (match_init, gap_extend, gap_init, start_gap,
// start_init, end_match, end_gap, end_skip).  The sites, M and pi are
// rounded to float32 as numpy's astype does, then gc_align_node runs.
// Writes len[b] (the mapping's length; -1 where a graph has a repeat slot,
// -2 where the backtrack failed: the caller aligns those pairs its staged
// way) and score[b].  Returns the staged batch, or null as above.
void* gc_align_batch_begin(int32_t B, const int32_t* dims,
                           const int64_t* ptrs, const float* scal,
                           int32_t* len, float* score, int32_t n_threads) {
  AlignBatch* ab = new AlignBatch();
  ab->map1.resize(B);
  ab->map2.resize(B);
  int64_t work = 0;
  for (int32_t b = 0; b < B; ++b)
    work += (int64_t)dims[5 * b] * dims[5 * b + 1] * (dims[5 * b + 4] + 8);
  n_threads = threads_for(kAlign, B, work, 1 << 22, n_threads);
  bool ok = for_each_item(B, n_threads, [&](int32_t b) {
    const int32_t* d = dims + 5 * b;
    const int32_t n1 = d[0], n2 = d[1], e1 = d[2], e2 = d[3], dim = d[4];
    const int64_t* p = ptrs + 10 * b;
    const uint8_t* r1 = at<uint8_t>(p, 2);
    const uint8_t* r2 = at<uint8_t>(p, 5);
    bool rep = false;
    for (int64_t q = 0; q < (int64_t)n1 * e1; ++q) rep |= r1[q] != 0;
    for (int64_t q = 0; q < (int64_t)n2 * e2; ++q) rep |= r2[q] != 0;
    if (rep) {
      len[b] = -1;
      return;
    }
    static thread_local std::vector<float> s1, s2, Mf, pif;
    auto round = [](const double* src, int64_t count,
                    std::vector<float>& dst) {
      dst.resize(count);
      for (int64_t q = 0; q < count; ++q) dst[q] = (float)src[q];
    };
    round(at<double>(p, 6), (int64_t)n1 * dim, s1);
    round(at<double>(p, 7), (int64_t)n2 * dim, s2);
    round(at<double>(p, 8), (int64_t)dim * dim, Mf);
    round(at<double>(p, 9), dim, pif);
    const float* c = scal + 8 * b;
    static thread_local std::vector<int32_t> t1, t2;
    const size_t cap = (size_t)n1 + n2 + 4;
    float wend = 0.0f;
    const int32_t n = gc_align_node(
        n1, n2, dim, e1, e2, at<int32_t>(p, 0), at<float>(p, 1),
        at<int32_t>(p, 3), at<float>(p, 4), s1.data(), s2.data(),
        Mf.data(), pif.data(), c[0], c[1], c[2], c[3], c[4], c[5], c[6],
        c[7], scratch(t1, cap), scratch(t2, cap), &wend);
    len[b] = n < 0 ? -2 : n;
    score[b] = wend;
    if (n > 0) {
      ab->map1[b].assign(t1.begin(), t1.begin() + n);
      ab->map2[b].assign(t2.begin(), t2.begin() + n);
    }
  });
  if (!ok) {
    delete ab;
    return nullptr;
  }
  return ab;
}

// Writes each aligned pair's mappings in walk order (the backtrack emits
// them reversed) into map1 and map2, the pairs one after another in their
// order, len[b] entries each.
void gc_align_batch_finish(void* staged, const int32_t* len, int32_t* map1,
                           int32_t* map2) {
  AlignBatch* ab = (AlignBatch*)staged;
  int64_t o = 0;
  for (size_t b = 0; b < ab->map1.size(); ++b) {
    if (len[b] < 0) continue;
    std::reverse_copy(ab->map1[b].begin(), ab->map1[b].end(), map1 + o);
    std::reverse_copy(ab->map2[b].begin(), ab->map2[b].end(), map2 + o);
    o += len[b];
  }
}

// --- merges (align/merge.py merge_graphs, native branch) -------------
namespace {
struct MergeItem {
  int32_t n = 0, dim = 0;
  std::vector<double> nodes;
  std::vector<int32_t> m1, m2;
  std::vector<uint8_t> matched;
  NodeEdges edges;
};
struct MergeBatch : Staged {
  std::vector<MergeItem> items;
};

// unclean_mapping (graph/graph.py): a cleaned graph's index through
// outmap (null: the graph was its own cleaning); false on an index
// outside either.
bool unclean(const int32_t* m, int32_t nmap, const int64_t* outmap,
             int32_t n_clean, int32_t n_graph, std::vector<int32_t>& out) {
  out.resize(nmap);
  for (int32_t j = 0; j < nmap; ++j) {
    int64_t v = m[j];
    if (v != -1) {
      if (v < 0 || v >= n_clean) return false;
      if (outmap) v = outmap[v];
      if (v < 0 || v >= n_graph) return false;
    }
    out[j] = (int32_t)v;
  }
  return true;
}
}  // namespace

// Node b merges g1 and g2 along the cleaned graphs' alignment: dims[8b..]
// = (nmap, n1, E1, n2, E2, dim, n_clean1, n_clean2),
// ptrs[16b..] = (map1 [nmap] int32, map2, outmap1 [n_clean1] int64 or 0,
// outmap2, sites1 [n1, dim] float64, idx1 [n1, E1] int32, cost1 float32,
// isrep1 uint8, units1 int32, sites2, idx2, cost2, isrep2, units2, P1
// [dim, dim] float64, P2), ups[2b..] = (up1, up2).  Per node: the
// mappings uncleaned, gc_unify's columns (mode 0, BLAS from gemv/ddot as
// gc_unify takes them), node_edges' edges.  Writes sizes[3b..] = (status,
// n, E): status 0, or -1 for an error in the mapping.  Returns the staged
// batch, or null as above.
void* gc_merge_batch_begin(int32_t B, const int32_t* dims,
                           const int64_t* ptrs, const float* ups,
                           void* gemv_fn, void* ddot_fn, int32_t blas64,
                           int32_t* sizes, int32_t n_threads) {
  MergeBatch* mb = new MergeBatch();
  mb->items.resize(B);
  int64_t work = 0;
  for (int32_t b = 0; b < B; ++b) {
    const int32_t* d = dims + 8 * b;
    work += ((int64_t)d[1] + d[3]) * ((int64_t)d[5] * d[5] + d[2] + d[4]);
  }
  n_threads = threads_for(kMergeBegin, B, work, 1 << 21, n_threads);
  bool ok = for_each_item(B, n_threads, [&](int32_t b) {
    const int32_t* d = dims + 8 * b;
    const int32_t nmap = d[0], n1 = d[1], e1 = d[2], n2 = d[3], e2 = d[4];
    const int32_t dim = d[5];
    const int64_t* p = ptrs + 16 * b;
    MergeItem& it = mb->items[b];
    std::vector<int32_t> map1, map2;
    sizes[3 * b] = -1;
    if (!unclean(at<int32_t>(p, 0), nmap, at<int64_t>(p, 2), d[6], n1,
                 map1)
        || !unclean(at<int32_t>(p, 1), nmap, at<int64_t>(p, 3), d[7], n2,
                    map2))
      return;
    const size_t cap = (size_t)n1 + n2 + 2;
    static thread_local std::vector<double> nodes;
    static thread_local std::vector<int32_t> m1, m2;
    static thread_local std::vector<uint8_t> matched;
    static thread_local NodeEdges edges;
    const int32_t n = gc_unify(
        gemv_fn, ddot_fn, blas64, dim, 0, nmap, map1.data(), map2.data(),
        at<double>(p, 4), at<double>(p, 9), at<double>(p, 14),
        at<double>(p, 15), scratch(nodes, cap * dim), scratch(m1, cap),
        scratch(m2, cap), scratch(matched, cap));
    if (n < 0) return;
    it.n = n;
    it.dim = dim;
    const int32_t E = node_edges(
        edges, n, m1.data(), m2.data(), matched.data(), n1, e1,
        at<int32_t>(p, 5), at<float>(p, 6), at<uint8_t>(p, 7),
        at<int32_t>(p, 8), n2, e2, at<int32_t>(p, 10), at<float>(p, 11),
        at<uint8_t>(p, 12), at<int32_t>(p, 13), ups[2 * b], ups[2 * b + 1],
        1);
    it.nodes.assign(nodes.begin(), nodes.begin() + (size_t)n * dim);
    it.m1.assign(m1.begin(), m1.begin() + n);
    it.m2.assign(m2.begin(), m2.begin() + n);
    it.matched.assign(matched.begin(), matched.begin() + n);
    NodeEdges& s = it.edges;
    s.ne = edges.ne;
    s.nr = edges.nr;
    s.eto.assign(edges.eto.begin(), edges.eto.begin() + s.ne);
    s.efrom.assign(edges.efrom.begin(), edges.efrom.begin() + s.ne);
    s.ecost.assign(edges.ecost.begin(), edges.ecost.begin() + s.ne);
    s.rto.assign(edges.rto.begin(), edges.rto.begin() + s.nr);
    s.rfrom.assign(edges.rfrom.begin(), edges.rfrom.begin() + s.nr);
    s.runits.assign(edges.runits.begin(), edges.runits.begin() + s.nr);
    sizes[3 * b] = 0;
    sizes[3 * b + 1] = n;
    sizes[3 * b + 2] = E;
  });
  if (!ok) {
    delete mb;
    return nullptr;
  }
  return mb;
}

// Fills node b: out[8b..] = (sites [n, dim] float64 with rows 0 and n - 1
// zero, m1 [n] int32, m2, matched [n] uint8, idx, cost, isrep, units
// [n, E] as gc_pad_edges packs them).  Returns 0, or -1 as above.
int32_t gc_merge_batch_finish(void* staged, const int32_t* sizes,
                              const int64_t* out, int32_t n_threads) {
  MergeBatch* mb = (MergeBatch*)staged;
  const int32_t B = (int32_t)mb->items.size();
  int64_t work = 0;
  for (int32_t b = 0; b < B; ++b)
    work += (int64_t)sizes[3 * b + 1] * (mb->items[b].dim + sizes[3 * b + 2]);
  n_threads = threads_for(kMergeFinish, B, work, 1 << 18, n_threads);
  bool ok = for_each_item(B, n_threads, [&](int32_t b) {
    const MergeItem& it = mb->items[b];
    const int32_t n = sizes[3 * b + 1], E = sizes[3 * b + 2];
    const int64_t* o = out + 8 * b;
    double* sites = (double*)(intptr_t)o[0];
    memcpy(sites, it.nodes.data(), (size_t)n * it.dim * sizeof(double));
    std::fill(sites, sites + it.dim, 0.0);
    std::fill(sites + (int64_t)(n - 1) * it.dim, sites + (int64_t)n * it.dim,
              0.0);
    memcpy((void*)(intptr_t)o[1], it.m1.data(), n * sizeof(int32_t));
    memcpy((void*)(intptr_t)o[2], it.m2.data(), n * sizeof(int32_t));
    memcpy((void*)(intptr_t)o[3], it.matched.data(), n);
    const NodeEdges& s = it.edges;
    gc_pad_edges(n, E, s.ne, s.eto.data(), s.efrom.data(), s.ecost.data(),
                 s.nr, s.rto.data(), s.rfrom.data(), s.runits.data(),
                 (int32_t*)(intptr_t)o[4], (float*)(intptr_t)o[5],
                 (uint8_t*)(intptr_t)o[6], (int32_t*)(intptr_t)o[7]);
  });
  return ok ? 0 : -1;
}

// --- row blocks (engine/progressive.py extend_children) --------------
// Node b's block dest [C, R] int16 (dims[2b..] = (C, K): K children,
// ptrs[b] = dest) takes its children's rows in turn: child j (the j-th
// of the node's entries in cdims / cptrs, from coff[b]) has cdims[2c..] =
// (rows, src_len) and cptrs[2c..] = (mapping [C + 2] int32, src
// [src_len, rows] int16).  The child's i-th mapped column (mapping[1 + j]
// != -1) takes row i of src, every other column the gap code.  Writes
// bad[b] = 1 where a child maps more columns than src_len (numpy's shape
// error), else 0.
void gc_extend_batch(int32_t B, const int32_t* dims, const int64_t* ptrs,
                     const int32_t* coff, const int32_t* cdims,
                     const int64_t* cptrs, int16_t gap, int32_t* bad,
                     int32_t n_threads) {
  int64_t work = 0;
  for (int32_t b = 0; b < B; ++b) {
    int32_t R = 0;
    for (int32_t j = 0; j < dims[2 * b + 1]; ++j)
      R += cdims[2 * (coff[b] + j)];
    work += (int64_t)dims[2 * b] * R;
  }
  n_threads = threads_for(kExtend, B, work, 1 << 20, n_threads);
  for_each_item(B, n_threads, [&](int32_t b) {
    const int32_t C = dims[2 * b], K = dims[2 * b + 1];
    int16_t* dest = (int16_t*)(intptr_t)ptrs[b];
    int32_t R = 0;
    for (int32_t j = 0; j < K; ++j) R += cdims[2 * (coff[b] + j)];
    bad[b] = 0;
    int32_t r0 = 0;
    for (int32_t j = 0; j < K; ++j) {
      const int32_t c = coff[b] + j;
      const int32_t rows = cdims[2 * c], src_len = cdims[2 * c + 1];
      const int32_t* mapping = at<int32_t>(cptrs, 2 * c);
      const int16_t* src = at<int16_t>(cptrs, 2 * c + 1);
      if (rows == 0) continue;
      int32_t i = 0;
      for (int32_t col = 0; col < C; ++col) {
        int16_t* d = dest + (int64_t)col * R + r0;
        if (mapping[col + 1] != -1) {
          if (i >= src_len) {
            bad[b] = 1;
            return;
          }
          memcpy(d, src + (int64_t)i * rows, rows * sizeof(int16_t));
          ++i;
        } else {
          std::fill(d, d + rows, gap);
        }
      }
      r0 += rows;
    }
  });
}

}  // extern "C"
