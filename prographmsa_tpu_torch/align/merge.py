"""Ancestral-graph construction from two aligned graphs.

Behavioral port of mergeGraphs / mergeGraphsIncremental
(GraphAlign.h:539-884): matched columns get the
normalized product of evolved child profiles; original edges are re-added
with the edge-half-life "unused" penalty; repeat edges carry over as unit
counts.

Parity quirk (reproduced intentionally): unmatched *insertion* columns from
graph 2 are evolved with ``model1.P`` (GraphAlign.h:591 uses model1, not
model2).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

from ..graph.graph import Graph
from .scores import LOG

f32 = np.float32


@dataclass
class AncestralResult:
    graph: Graph
    mapping1: List[int]
    mapping2: List[int]
    is_matched: List[bool]


def _norm_or_zero(p: np.ndarray) -> np.ndarray:
    n = np.linalg.norm(p)
    return p if n == 0 else p / n


def _update_edge(edges: Dict[Tuple[int, int], float], frm: int, to: int,
                 cost) -> None:
    key = (to, frm)
    if key in edges:
        edges[key] = min(edges[key], cost)
    else:
        edges[key] = cost


def _unify(nodes, result_m1, result_m2, is_matched, mapping1, mapping2,
           col1, col2, col_match):
    """Shared unification loop (GraphAlign.h:569-620): emit unmatched runs
    then the mapped column, tracking is_matched flags.

    col1(i)/col2(i): profile for an unmatched column of graph1/graph2;
    col_match(k1,k2)/col1/col2 for mapped columns."""
    i1 = i2 = 0
    for j in range(len(mapping1)):
        k1 = mapping1[j]
        k2 = mapping2[j]
        if k1 != -1:
            while i1 != k1:
                nodes.append(_norm_or_zero(col1(i1)))
                result_m1.append(i1)
                result_m2.append(-1)
                is_matched.append(False)
                i1 += 1
            i1 += 1
        if k2 != -1:
            while i2 != k2:
                nodes.append(_norm_or_zero(col2(i2)))
                result_m1.append(-1)
                result_m2.append(i2)
                is_matched.append(False)
                i2 += 1
            i2 += 1
        if k1 != -1 and k2 != -1:
            nodes.append(_norm_or_zero(col_match(k1, k2)))
            result_m1.append(k1)
            result_m2.append(k2)
        elif k1 != -1:
            nodes.append(_norm_or_zero(col1(k1)))
            result_m1.append(k1)
            result_m2.append(-1)
        elif k2 != -1:
            nodes.append(_norm_or_zero(col2(k2)))
            result_m1.append(-1)
            result_m2.append(k2)
        else:
            raise AssertionError("error in mapping")
        is_matched.append(True)


def _homologous_path_edges(edges, result_m1, result_m2, is_matched, n_nodes):
    """Free edges chaining matched columns + skip edges over fresh
    insertions (GraphAlign.h:626-657)."""
    last_xy = last_x = last_y = last_mapped = 0
    for i in range(1, n_nodes):
        if not is_matched[i]:
            continue
        _update_edge(edges, last_mapped, i, f32(0.0))
        last_mapped = i
        if result_m1[i] != -1 and result_m2[i] != -1:
            if last_xy != i - 1:
                _update_edge(edges, last_xy, i, f32(0.0))
            last_xy = i
        if result_m1[i] != -1:
            if last_y != i - 1:
                _update_edge(edges, last_y, i, f32(0.0))
            last_y = i
        if result_m2[i] != -1:
            if last_x != i - 1:
                _update_edge(edges, last_x, i, f32(0.0))
            last_x = i


def _inverse_mapping(result_m, size):
    inv = np.zeros(size, dtype=np.int64)
    ma = np.asarray(result_m, dtype=np.int64)
    idx = np.nonzero(ma != -1)[0]
    inv[ma[idx]] = idx
    return inv


def _readd_edges(edges, repeats, graph, inv_map, is_matched, unused_penalty):
    """Re-add original edges with half-life penalties
    (GraphAlign.h:685-722); ``unused_penalty=None`` -> incremental variant
    (no penalties, GraphAlign.h:856-879)."""
    for to in range(graph.size):
        for p, c, is_rep, units in graph.pred_items(to, 0.0, 0.0):
            yy = int(inv_map[p])
            xx = int(inv_map[to])
            if not is_rep:
                if unused_penalty is None:
                    _update_edge(edges, yy, xx, c)
                elif is_matched[p] and is_matched[to]:
                    _update_edge(edges, yy, xx, f32(c + unused_penalty))
                elif is_matched[p] or is_matched[to]:
                    _update_edge(edges, yy, xx,
                                 f32(c + f32(unused_penalty / 2)))
                else:
                    _update_edge(edges, yy, xx, c)
            else:
                key = (xx, yy)
                if key in repeats:
                    repeats[key] = min(repeats[key], units)
                else:
                    repeats[key] = units


def _graph_from_padded(nodes: np.ndarray, padded) -> Graph:
    """Graph from the fused native merge's padded arrays."""
    n = nodes.shape[0]
    sites = np.ascontiguousarray(nodes, dtype=np.float64)
    if sites is nodes:
        sites = sites.copy()
    sites[0] = 0.0
    sites[n - 1] = 0.0
    return Graph.from_padded(sites, *padded)


def _graph_from_edge_arrays(nodes: np.ndarray, arrs) -> Graph:
    """Graph from the native kernel's pre-sorted, pre-quantized edge arrays
    (the fast-path equivalent of Graph.from_maps)."""
    e_to, e_from, e_cost, r_to, r_from, r_units = arrs
    n = nodes.shape[0]
    sites = nodes.astype(np.float64).copy()
    sites[0] = 0.0
    sites[n - 1] = 0.0
    from .. import native
    padded = native.pad_edges_native(n, e_to, e_from, e_cost,
                                     r_to, r_from, r_units)
    if padded is None:
        from ..graph.graph import padded_from_edges
        padded = padded_from_edges(n, e_to, e_from, e_cost,
                                   r_to, r_from, r_units)
    return Graph.from_padded(sites, *padded)


def _unused_penalty(options, support) -> np.float32:
    """The half-life penalty of a child's unused edges (GraphAlign.h:
    685-722), float32."""
    asp = options.altsplice_prob
    return f32(-LOG(asp + (1.0 - asp) * (1.0 - support)))


def merge_graphs(g1: Graph, g2: Graph, mapping1, mapping2, model1, model2,
                 support1: float, support2: float, options) -> AncestralResult:
    nodes: List[np.ndarray] = []
    edges: Dict[Tuple[int, int], float] = {}
    repeats: Dict[Tuple[int, int], int] = {}
    m1: List[int] = []
    m2: List[int] = []
    matched: List[bool] = []

    P1, P2 = model1.P, model2.P
    nodes_arr = None
    use_native = getattr(options, "engine", "auto") in ("auto", "native")
    if use_native:
        from .. import native
        u = native.unify_native(0, mapping1, mapping2, g1.sites, g2.sites,
                                P1, P2)
        if u is not None:
            nodes_arr, m1a, m2a, matched_a = u
            m1 = m1a.tolist()
            m2 = m2a.tolist()
            matched = matched_a.tolist()
    if nodes_arr is None:
        # NOTE: unmatched g2 columns use model1.P (reference parity,
        # GraphAlign.h:591)
        _unify(nodes, m1, m2, matched, mapping1, mapping2,
               col1=lambda i: P1 @ g1.sites[i],
               col2=lambda i: P1 @ g2.sites[i],
               col_match=lambda k1, k2: (P1 @ g1.sites[k1])
                                        * (P2 @ g2.sites[k2]))
        # ...but mapped single-sided g2 columns use model2.P
        # (GraphAlign.h:612) — fix up: re-emit those columns
        for j in range(len(m1)):
            if matched[j] and m1[j] == -1 and m2[j] != -1:
                nodes[j] = _norm_or_zero(P2 @ g2.sites[m2[j]])
        nodes_arr = np.array(nodes)

    up1 = _unused_penalty(options, support1)
    up2 = _unused_penalty(options, support2)

    if use_native:
        from .. import native
        padded = native.merge_node_native(m1, m2, matched, g1, g2,
                                          up1, up2, True)
        if padded is not None:
            graph = _graph_from_padded(nodes_arr, padded)
            return AncestralResult(graph=graph, mapping1=m1, mapping2=m2,
                                   is_matched=matched)

    inv1 = _inverse_mapping(m1, g1.size)
    inv2 = _inverse_mapping(m2, g2.size)

    _homologous_path_edges(edges, m1, m2, matched, len(nodes_arr))
    _readd_edges(edges, repeats, g1, inv1, matched, up1)
    _readd_edges(edges, repeats, g2, inv2, matched, up2)

    graph = Graph.from_maps(nodes_arr, edges, repeats)
    return AncestralResult(graph=graph, mapping1=m1, mapping2=m2,
                           is_matched=matched)


def merge_graphs_batch(nodes, options) -> List[AncestralResult]:
    """``merge_graphs`` of many nodes in one native batch
    (native.merge_batch; ``native.batches(options)`` must hold), each node
    (g1, g2, mapping1, mapping2, outmapping1, outmapping2, model1, model2,
    support1, support2) with the mappings of the two cleaned graphs'
    alignment and the cleanings' outmappings (unclean_mapping is applied
    in the batch).  The same graphs, mappings and matched flags as
    merge_graphs' native branch, the flags and mappings as arrays."""
    from .. import native
    got = native.merge_batch([
        (map1, map2, om1, om2, g1, g2, mo1.P, mo2.P,
         _unused_penalty(options, s1), _unused_penalty(options, s2))
        for g1, g2, map1, map2, om1, om2, mo1, mo2, s1, s2 in nodes])
    return [AncestralResult(graph=Graph.from_padded(sites, *padded),
                            mapping1=m1, mapping2=m2, is_matched=matched)
            for sites, m1, m2, matched, *padded in got]


def merge_graphs_incremental(anc_graph: Graph, graph: Graph, anc_mapping,
                             mapping, model) -> AncestralResult:
    """mergeGraphsIncremental (GraphAlign.h:729-884): merge a new child into
    an evolving ancestor graph without applying P to the ancestor again and
    without unused-edge penalties."""
    nodes: List[np.ndarray] = []
    edges: Dict[Tuple[int, int], float] = {}
    repeats: Dict[Tuple[int, int], int] = {}
    m1: List[int] = []
    m2: List[int] = []
    matched: List[bool] = []

    P = model.P
    from .. import native
    nodes_arr = None
    u = native.unify_native(1, anc_mapping, mapping, anc_graph.sites,
                            graph.sites, P, P)
    if u is not None:
        nodes_arr, m1a, m2a, matched_a = u
        m1 = m1a.tolist()
        m2 = m2a.tolist()
        matched = matched_a.tolist()
    if nodes_arr is None:
        _unify(nodes, m1, m2, matched, anc_mapping, mapping,
               col1=lambda i: anc_graph.sites[i],
               col2=lambda i: P @ graph.sites[i],
               col_match=lambda k1, k2: anc_graph.sites[k1]
                                        * (P @ graph.sites[k2]))
        nodes_arr = np.array(nodes)

    padded = native.merge_node_native(m1, m2, matched, anc_graph, graph,
                                      0.0, 0.0, False)
    if padded is not None:
        g = _graph_from_padded(nodes_arr, padded)
        return AncestralResult(graph=g, mapping1=m1, mapping2=m2,
                               is_matched=matched)

    inv1 = _inverse_mapping(m1, anc_graph.size)
    inv2 = _inverse_mapping(m2, graph.size)

    _homologous_path_edges(edges, m1, m2, matched, len(nodes_arr))
    _readd_edges(edges, repeats, anc_graph, inv1, matched, None)
    _readd_edges(edges, repeats, graph, inv2, matched, None)

    g = Graph.from_maps(nodes_arr, edges, repeats)
    return AncestralResult(graph=g, mapping1=m1, mapping2=m2,
                           is_matched=matched)
