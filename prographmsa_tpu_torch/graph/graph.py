"""Sequence-graph data structure (array form).

Re-derivation of Graph.h as plain arrays instead of Eigen
sparse matrices:

* ``sites``: [n, DIM] float64 profile (row per node; node 0 and n-1 are
  zero start/end sentinels, Graph.h:104-120).
* predecessor edges: per-node ascending lists of (pred, cost); cost is the
  *retrieved* float32 cost.  The reference stores ``min(cost,1e4)-1e4`` as
  float32 and retrieves ``stored+1e4`` (Graph.h:81-90,223-230) — this
  quantizes costs to ~2^-10 near 1e4 and maps cost>=1e4 to +inf; we apply
  the identical quantization at insertion (``quantize_cost``) so DP scores
  match the reference bitwise.
* repeat (tandem-repeat unit skip) edges as per-node ascending lists of
  (pred, units); their cost is ``repeat_init + repeat_ext*(units-1)``
  computed at DP time (Graph.h:236).

Predecessor iteration order (normal edges ascending, then repeat edges
ascending) matches the reference's row-major sparse inner iteration, which
the backtracking tie-breaks depend on.

For the device DP kernel, ``padded()`` exports fixed-capacity arrays
(pred_idx/pred_cost [n, E] with sentinel padding).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

MAX_EDGE_COST = np.float32(10000.0)
INF = np.float32(np.inf)


def quantize_cost(cost) -> np.float32:
    """Reproduce the store/retrieve float32 rounding of edge costs."""
    c = np.float32(min(np.float64(cost), np.float64(MAX_EDGE_COST)))
    stored = np.float32(c - MAX_EDGE_COST)
    if stored == np.float32(0.0):
        return INF
    return np.float32(stored + MAX_EDGE_COST)


class Graph:
    __slots__ = ("sites", "_preds", "_reps", "_pad_cache")

    def __init__(self, sites: np.ndarray,
                 preds: List[List[Tuple[int, np.float32]]],
                 reps: List[List[Tuple[int, int]]]):
        self.sites = sites          # [n, DIM] float64
        self._preds = preds         # per-node [(pred, cost_f32)] ascending
        self._reps = reps           # per-node [(pred, units)] ascending
        self._pad_cache = None      # memoized padded() export

    # The edge lists and the padded arrays are dual views; graphs built by
    # the native kernels carry only the padded arrays and materialize the
    # lists lazily (cold paths: Python DP fallbacks, find-root, output).
    @property
    def preds(self):
        if self._preds is None:
            self._materialize_lists()
        return self._preds

    @preds.setter
    def preds(self, value):
        if self._reps is None and self._pad_cache is not None:
            self._materialize_lists()   # keep the reps view alive
        self._preds = value
        self._pad_cache = None

    @property
    def reps(self):
        if self._reps is None:
            self._materialize_lists()
        return self._reps

    @reps.setter
    def reps(self, value):
        if self._preds is None and self._pad_cache is not None:
            self._materialize_lists()   # keep the preds view alive
        self._reps = value
        self._pad_cache = None

    def _materialize_lists(self) -> None:
        idx, cost, isrep, units = self._pad_cache
        n, E = idx.shape
        preds: List[List] = [[] for _ in range(n)]
        reps: List[List] = [[] for _ in range(n)]
        il, cl, rl, ul = idx.tolist(), cost, isrep.tolist(), units.tolist()
        for i in range(n):
            row = il[i]
            for k in range(E):
                p = row[k]
                if p < 0:
                    continue
                if rl[i][k]:
                    reps[i].append((p, ul[i][k]))
                else:
                    preds[i].append((p, cl[i, k]))
        self._preds = preds
        self._reps = reps

    @classmethod
    def from_padded(cls, sites: np.ndarray, idx, cost, isrep, units
                    ) -> "Graph":
        """Graph whose primary representation is the padded arrays (slot
        layout per row: normal edges ascending, then repeat edges
        ascending — the PredIterator order)."""
        g = cls(sites, None, None)
        g._pad_cache = (idx, cost, isrep, units)
        return g

    # ------------------------------------------------------------------
    @property
    def size(self) -> int:
        return self.sites.shape[0]

    @property
    def dim(self) -> int:
        return self.sites.shape[1]

    def copy(self) -> "Graph":
        return Graph(self.sites.copy(),
                     [list(p) for p in self.preds],
                     [list(r) for r in self.reps])

    # ------------------------------------------------------------------
    @classmethod
    def from_profile(cls, profile: np.ndarray) -> "Graph":
        """Linear chain over profile columns; adds zero start/end sentinels
        and free edges i -> i+1 (Graph.h:104-120, fillInitialEdges)."""
        n = profile.shape[0] + 2
        dim = profile.shape[1]
        sites = np.zeros((n, dim), dtype=np.float64)
        sites[1:n - 1] = profile
        idx = np.arange(-1, n - 1, dtype=np.int32).reshape(n, 1)
        cost = np.zeros((n, 1), dtype=np.float32)
        cost[0, 0] = np.inf
        return cls.from_padded(sites, idx, cost,
                               np.zeros((n, 1), dtype=bool),
                               np.zeros((n, 1), dtype=np.int32))

    @classmethod
    def from_maps(cls, nodes: np.ndarray,
                  edge_map: Dict[Tuple[int, int], float],
                  repeat_map: Dict[Tuple[int, int], int]) -> "Graph":
        """Graph(nodes, edges, repeats) ctor (Graph.h:122-139): ``nodes``
        includes the zero sentinels; maps are keyed (to, from)."""
        n = nodes.shape[0]
        sites = nodes.astype(np.float64).copy()
        sites[0] = 0.0
        sites[n - 1] = 0.0
        preds = [[] for _ in range(n)]
        reps = [[] for _ in range(n)]
        # vectorized quantize_cost over all edges (same per-element ops)
        keys = sorted(edge_map)
        if keys:
            costs = np.array([float(edge_map[k]) for k in keys],
                             dtype=np.float64)
            c = np.minimum(costs, np.float64(MAX_EDGE_COST)).astype(np.float32)
            stored = (c - MAX_EDGE_COST).astype(np.float32)
            q = np.where(stored == np.float32(0.0), INF,
                         (stored + MAX_EDGE_COST).astype(np.float32))
            for (to, frm), qc in zip(keys, q):
                preds[to].append((frm, qc))
        for (to, frm) in sorted(repeat_map):
            units = repeat_map[(to, frm)]
            # stored index_t 0 would read as "no edge" -> inf; units>0 normal
            if units > 0:
                reps[to].append((frm, int(units)))
        return cls(sites, preds, reps)

    # ------------------------------------------------------------------
    def pred_items(self, node: int, repeat_init, repeat_ext):
        """PredIterator semantics (Graph.h:180-248): yields
        (pred, cost, is_repeat, units).  Repeat-edge cost =
        repeat_init + repeat_ext*(units-1)."""
        for p, c in self.preds[node]:
            yield p, np.float32(c), False, 0
        for p, u in self.reps[node]:
            with np.errstate(invalid="ignore"):   # inf*0 when u == 1
                yield p, np.float32(repeat_init + repeat_ext * (u - 1)), True, u

    def add_repeats(self, tr_homologies: List[np.ndarray]) -> None:
        """Rebuild repeat edges from TR homology tracks
        (Graph.h:48-79,458-469)."""
        repeat_map: Dict[Tuple[int, int], int] = {}
        for tr in tr_homologies:
            _repeat_edges(repeat_map, tr)
        if not repeat_map:
            # no repeat edges to overlay; keep the pad cache iff it already
            # has none (the common leaf-merge case)
            if self._pad_cache is not None and not self._pad_cache[2].any():
                if self._reps is not None:
                    self._reps = [[] for _ in range(self.size)]
                return
            if self._reps is not None and not any(self._reps):
                return
        reps: List[List[Tuple[int, int]]] = [[] for _ in range(self.size)]
        for (to, frm) in sorted(repeat_map):
            units = repeat_map[(to, frm)]
            if units > 0:
                reps[to].append((frm, units))
        self.reps = reps
        self._pad_cache = None

    def reset_sites(self) -> None:
        """Graph::reset (Graph.h:369-373)."""
        self.sites[:, :] = 1.0
        self.sites[0] = 0.0
        self.sites[-1] = 0.0

    def rm_nodes(self, first: int, count: int = 1) -> None:
        """Graph::rmNodes (Graph.h:375-427): delete nodes [first,
        first+count), shifting indices and dropping incident edges."""
        assert first >= 1 and first + count <= self.size
        n_new = self.size - count

        def shift(i):
            return i - count if i >= first else i

        new_preds: List[List[Tuple[int, np.float32]]] = [[] for _ in range(n_new)]
        new_reps: List[List[Tuple[int, int]]] = [[] for _ in range(n_new)]
        for to in range(self.size):
            if first <= to < first + count:
                continue
            for p, c in self.preds[to]:
                if not (first <= p < first + count):
                    new_preds[shift(to)].append((shift(p), c))
            for p, u in self.reps[to]:
                if not (first <= p < first + count):
                    new_reps[shift(to)].append((shift(p), u))
        self.sites = np.delete(self.sites, slice(first, first + count), axis=0)
        self.preds = new_preds
        self.reps = new_reps
        self._pad_cache = None

    # ------------------------------------------------------------------
    def padded(self):
        """Fixed-capacity arrays for the device DP kernel:
        (pred_idx [n,E] int32 w/ -1 pad, pred_cost [n,E] float32 w/ +inf pad,
        is_rep [n,E] bool, rep_units [n,E] int32).  Memoized; mutators
        invalidate."""
        if self._pad_cache is not None:
            return self._pad_cache
        n = self.size
        emax = max(1, max(len(self.preds[i]) + len(self.reps[i])
                          for i in range(n)))
        idx = np.full((n, emax), -1, dtype=np.int32)
        cost = np.full((n, emax), np.inf, dtype=np.float32)
        isrep = np.zeros((n, emax), dtype=bool)
        units = np.zeros((n, emax), dtype=np.int32)
        for i in range(n):
            k = 0
            for p, c in self.preds[i]:
                idx[i, k] = p
                cost[i, k] = c
                k += 1
            for p, u in self.reps[i]:
                idx[i, k] = p
                isrep[i, k] = True
                units[i, k] = u
                k += 1
        self._pad_cache = (idx, cost, isrep, units)
        return self._pad_cache


def padded_from_edges(n: int, e_to, e_from, e_cost, r_to, r_from, r_units):
    """Vectorized padded-array construction from (to, from)-sorted edge
    arrays (the native kernels' output format): normal edges fill the
    leading slots of each row ascending, repeat edges follow — the same
    slot layout ``Graph.padded()`` derives from the lists."""
    # The slot arithmetic below requires the edge arrays grouped by
    # ascending 'to' (ascending 'from' within a group) — both native
    # producers emit this order; fail loudly on any future producer that
    # does not, instead of silently mis-wiring slots.
    assert np.all(np.diff(e_to) >= 0), "edges must be sorted by 'to'"
    assert np.all(np.diff(r_to) >= 0), "repeat edges must be sorted by 'to'"
    cnt_e = np.bincount(e_to, minlength=n)
    cnt_r = np.bincount(r_to, minlength=n) if len(r_to) else np.zeros(
        n, dtype=np.int64)
    E = max(1, int((cnt_e + cnt_r).max()))
    idx = np.full((n, E), -1, dtype=np.int32)
    cost = np.full((n, E), np.inf, dtype=np.float32)
    isrep = np.zeros((n, E), dtype=bool)
    units = np.zeros((n, E), dtype=np.int32)
    if len(e_to):
        pos = np.arange(len(e_to)) - np.repeat(np.cumsum(cnt_e) - cnt_e,
                                               cnt_e)
        idx[e_to, pos] = e_from
        cost[e_to, pos] = e_cost
    if len(r_to):
        pos = (np.arange(len(r_to))
               - np.repeat(np.cumsum(cnt_r) - cnt_r, cnt_r) + cnt_e[r_to])
        idx[r_to, pos] = r_from
        isrep[r_to, pos] = True
        units[r_to, pos] = r_units
    return idx, cost, isrep, units


def _repeat_edges(repeat_map: Dict[Tuple[int, int], int],
                  tr_homology: np.ndarray, offset: int = 0) -> None:
    """Graph::getRepeatEdges (Graph.h:48-79): convert a per-node repeat-unit
    column track into unit-skip edges with min-combined unit counts."""
    tr = list(tr_homology)
    n = len(tr)
    for frm in range(n):
        if tr[frm] < 0:
            continue
        n_units = 0
        take_next = False
        for to in range(frm + 1, n):
            if tr[to] < 0:
                continue
            if tr[to] <= tr[to - 1]:
                n_units += 1
            if take_next:
                key = (offset + to, offset + frm)
                if key in repeat_map:
                    repeat_map[key] = min(repeat_map[key], n_units)
                else:
                    repeat_map[key] = n_units
                take_next = False
            if tr[to] == tr[frm]:
                take_next = True


def sequence_graph(spec, seq: np.ndarray) -> Graph:
    """SequenceGraph from one sequence: one-hot columns, unknowns uniform
    (SequenceGraph.h:45-54,101-109)."""
    vals = spec.values(seq)
    n = len(vals)
    profile = np.zeros((n, spec.DIM), dtype=np.float64)
    valid = (vals >= 0) & (vals < spec.DIM)
    profile[np.arange(n)[valid], vals[valid]] = 1.0
    profile[~valid] = 1.0 / spec.DIM
    return Graph.from_profile(profile)


def clean_graph(graph: Graph, options):
    """CleanedGraph (CleanedGraph.h:38-146): keep only nodes on a
    finite-cost start->end path; returns (cleaned Graph, outmapping)."""
    n = graph.size
    repeat_ext = INF if options.repeatext_prob == 0 else np.float32(0.0)

    # Fast path: a repeat-free linear chain with finite costs cleans to
    # itself (every node lies on the unique start->end path, ascending
    # order and costs preserved by CleanedGraph.h:96-132).
    # NOTE: this path ALIASES — the returned Graph *is* the input object
    # (every other path returns a fresh Graph).  Callers must treat
    # cleaned graphs as read-only; mutating one here would corrupt the
    # source graph later consumed by merge_graphs.
    pidx, pcost, pisrep, _ = graph.padded()
    if (pidx.shape[1] == 1 and not pisrep.any()
            and np.array_equal(pidx[:, 0],
                               np.arange(-1, n - 1, dtype=np.int32))
            and np.isfinite(pcost[1:, 0]).all()):
        return graph, np.arange(n, dtype=np.int64)

    if getattr(options, "engine", "auto") in ("auto", "native"):
        from .. import native
        res = native.clean_graph_native(graph, repeat_ext)
        if res is not None:
            mapping, new_dim, e_to, e_from, e_cost, r_to, r_from, r_units = res
            keep = mapping != -1
            sites = graph.sites[keep].copy()
            sites_order = np.argsort(mapping[keep], kind="stable")
            sites = sites[sites_order]
            padded = native.pad_edges_native(new_dim, e_to, e_from, e_cost,
                                             r_to, r_from, r_units)
            if padded is None:
                padded = padded_from_edges(new_dim, e_to, e_from, e_cost,
                                           r_to, r_from, r_units)
            cleaned = Graph.from_padded(sites, *padded)
            outmapping = np.flatnonzero(keep).astype(np.int64)[sites_order]
            return cleaned, outmapping

    marked_fw = np.zeros(n, dtype=bool)
    marked_bw = np.zeros(n, dtype=bool)
    mapping = np.full(n, -1, dtype=np.int64)
    marked_fw[0] = True
    marked_bw[n - 1] = True
    mapping[0] = 0
    new_dim = 1

    # repeat-edge traversability under (repeat_init=0, repeat_ext);
    # inf*0 -> NaN (units==1 with repeat_ext=inf) and NaN != INF, so such
    # edges stay traversable — matched by the native kernel
    def edges_of(to):
        for p, c in graph.preds[to]:
            yield p, c
        with np.errstate(invalid="ignore"):
            for p, u in graph.reps[to]:
                yield p, np.float32(0.0 + repeat_ext * (u - 1))

    for to in range(n - 1, 0, -1):
        if not marked_bw[to]:
            continue
        for p, c in edges_of(to):
            if c != INF:
                marked_bw[p] = True

    for to in range(1, n):
        for p, c in edges_of(to):
            if c != INF and marked_fw[p]:
                marked_fw[to] = True
                if marked_bw[to]:
                    mapping[to] = new_dim
                    new_dim += 1
                break

    assert marked_bw[0] and marked_fw[n - 1]

    sites = np.zeros((new_dim, graph.dim), dtype=np.float64)
    preds: List[List[Tuple[int, np.float32]]] = [[] for _ in range(new_dim)]
    reps: List[List[Tuple[int, int]]] = [[] for _ in range(new_dim)]
    for to in range(n):
        y = mapping[to]
        if y == -1:
            continue
        sites[y] = graph.sites[to]
        for p, c in graph.preds[to]:
            x = mapping[p]
            if x != -1 and c != INF:   # stored<0 <=> finite cost
                preds[y].append((x, c))
        for p, u in graph.reps[to]:
            x = mapping[p]
            if x != -1 and u > 0:
                reps[y].append((x, u))
        preds[y].sort(key=lambda t: t[0])
        reps[y].sort(key=lambda t: t[0])

    outmapping = np.zeros(new_dim, dtype=np.int64)
    for i in range(n):
        if mapping[i] != -1:
            outmapping[mapping[i]] = i

    return Graph(sites, preds, reps), outmapping


def clean_graphs(graphs, options):
    """``clean_graph`` of each of ``graphs`` in one native batch
    (native.clean_batch; the library must be loaded): the same (cleaned
    Graph, outmapping) pairs, a linear chain aliased to itself as
    clean_graph's fast path aliases it."""
    from .. import native
    repeat_ext = INF if options.repeatext_prob == 0 else np.float32(0.0)
    out = []
    for g, r in zip(graphs, native.clean_batch(graphs, repeat_ext)):
        if r is None:
            out.append((g, np.arange(g.size, dtype=np.int64)))
        else:
            sites, outmapping, *padded = r
            out.append((Graph.from_padded(sites, *padded), outmapping))
    return out


def unclean_mapping(mapping: List[int], outmapping: np.ndarray) -> List[int]:
    """CleanedGraph::uncleanMapping (CleanedGraph.h:152-160)."""
    m = np.asarray(mapping, dtype=np.int64)
    out = np.where(m == -1, -1, outmapping[np.maximum(m, 0)])
    return out.tolist()
