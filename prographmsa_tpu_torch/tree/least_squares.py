"""Weighted-least-squares guide-tree refinement (-W quartets, -WW quintets).

Re-derivation of LeastSquares.cpp: the rooted NJ tree
becomes an unrooted node/edge graph; every internal edge's local branch
lengths are re-fit by NNLS over the weighted path-length design matrix of
the 3 quartet topologies (Opt4/OptimizeQuartet, LeastSquares.cpp:219-348);
-WW additionally tries all 15 five-taxon topologies around each internal
node (Opt5v1/v2/OptimizeQuintet, LeastSquares.cpp:351-652).  Edge support
comes from the quartet fit differences 1/(1+e^{(f2-f1)/-2}+e^{(f3-f1)/-2}).
Iterated until the weighted fit stops improving (MAX_ITERS 20).

Parity notes: the reference accumulates quartet distances by iterating
std::map<const Node*,..> — pointer order == node-array creation order, so
we key by each node's creation index; leaf-adjacent edges only get their
support refreshed from branch length (LeastSquares.cpp:287-290).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
from ..errors import ParityError

from .nnls import nnls
from .phytree import PhyTree

MAX_ITERS = 20
MAX_ITERS5 = 5


def _support(d: float, options) -> float:
    """Branch support from length (LeastSquares.cpp:16-23)."""
    s = 1.0 - math.exp(-math.log(2.0) * d / options.edge_halflife)
    s = min(1.0, max(0.0, s))
    if math.isnan(s):
        s = 0.0
    return s


class Node:
    __slots__ = ("edges", "leaf", "todo", "idx")

    def __init__(self, idx: int):
        self.edges: List[Optional["Edge"]] = [None, None, None]
        self.leaf = -1
        self.todo = False
        self.idx = idx

    def is_leaf(self) -> bool:
        return self.leaf != -1


class Edge:
    __slots__ = ("nodes", "length", "support")

    def __init__(self):
        self.nodes: List[Optional[Node]] = [None, None]
        self.length = 0.0
        self.support = -1.0

    def other(self, n: Node) -> Node:
        return self.nodes[1] if self.nodes[0] is n else self.nodes[0]


class Graph:
    """LeastSquares::Graph (LeastSquares.cpp:64-200)."""

    def __init__(self, tree: PhyTree, leaves_order: List[str]):
        assert tree.n_children() == 2
        self.labels = list(leaves_order)
        self.n_leaves = len(leaves_order)
        self.nodes: List[Node] = []
        self.edges: List[Edge] = []

        e0 = self._new_edge()
        e0.length = tree[0].branch_length + tree[1].branch_length
        e0.nodes[0] = self._tree2graph(tree[0], e0)
        e0.nodes[1] = self._tree2graph(tree[1], e0)
        assert len(self.nodes) == 2 * self.n_leaves - 2
        assert len(self.edges) == 2 * self.n_leaves - 3

    def _new_edge(self) -> Edge:
        e = Edge()
        self.edges.append(e)
        return e

    def _tree2graph(self, tree: PhyTree, edge: Edge) -> Node:
        node = Node(len(self.nodes))
        self.nodes.append(node)
        if tree.is_leaf():
            node.edges[0] = edge
            try:
                node.leaf = self.labels.index(tree.name)
            except ValueError:
                raise ParityError("unknown leaf name: %s" % tree.name)
        else:
            node.edges[0] = edge
            e1 = self._new_edge()
            e1.length = tree[0].branch_length
            e1.nodes[0] = node
            e1.nodes[1] = self._tree2graph(tree[0], e1)
            node.edges[1] = e1
            e2 = self._new_edge()
            e2.length = tree[1].branch_length
            e2.nodes[0] = node
            e2.nodes[1] = self._tree2graph(tree[1], e2)
            node.edges[2] = e2
        return node

    def subtree_dist(self, node: Node, from_edge: Edge
                     ) -> List[Tuple[Node, float]]:
        """Leaf distances in node-creation (== pointer) order
        (LeastSquares.cpp:111-127)."""
        dists: Dict[int, Tuple[Node, float]] = {}

        def rec(n: Node, frm: Edge, dist: float):
            if n.is_leaf():
                dists[n.idx] = (n, dist)
            else:
                for e in n.edges:
                    if e is not frm:
                        rec(e.other(n), e, dist + e.length)

        rec(node, from_edge, 0.0)
        return [dists[k] for k in sorted(dists)]

    def to_tree(self) -> PhyTree:
        e = self.edges[0]
        root = PhyTree()
        root.add_child(self._to_tree(e.nodes[0], e), e.length / 2.0,
                       e.support)
        root.add_child(self._to_tree(e.nodes[1], e), e.length / 2.0,
                       e.support)
        return root

    def _to_tree(self, node: Node, from_edge: Edge) -> PhyTree:
        if node.is_leaf():
            return PhyTree(self.labels[node.leaf])
        tree = PhyTree()
        for e in node.edges:
            if e is not from_edge:
                tree.add_child(self._to_tree(e.other(node), e), e.length,
                               e.support)
        return tree


def compute_fit(g: Graph, distances: np.ndarray,
                var_inv: np.ndarray) -> float:
    """LeastSquares::computeFit (LeastSquares.cpp:202-217)."""
    fit = 0.0
    for n in g.nodes:
        if not n.is_leaf():
            continue
        i1 = n.leaf
        e0 = n.edges[0]
        for leaf_node, d in g.subtree_dist(e0.other(n), e0):
            i2 = leaf_node.leaf
            diff = d + e0.length - distances[i1, i2]
            fit += diff * var_inv[i1, i2] * diff
    return fit


_DATA4 = np.array([
    [1, 1, 0, 0, 0],
    [1, 0, 1, 0, 1],
    [1, 0, 0, 1, 1],
    [0, 1, 1, 0, 1],
    [0, 1, 0, 1, 1],
    [0, 0, 1, 1, 0]], dtype=np.float64)

_PAIRS4 = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]
_PAIRS5 = [(0, 1), (0, 2), (0, 3), (0, 4), (1, 2), (1, 3), (1, 4),
           (2, 3), (2, 4), (3, 4)]

# Opt5v1 (node 4 attached at the branch to subtree 0, LeastSquares.cpp:353)
_DATA5V1 = np.array([
    [1, 1, 0, 0, 0, 0, 0],
    [1, 0, 1, 0, 0, 1, 0],
    [1, 0, 0, 1, 0, 1, 0],
    [1, 0, 0, 0, 1, 0, 0],
    [0, 1, 1, 0, 0, 1, 0],
    [0, 1, 0, 1, 0, 1, 0],
    [0, 1, 0, 0, 1, 0, 1],
    [0, 0, 1, 1, 0, 0, 0],
    [0, 0, 1, 0, 1, 1, 1],
    [0, 0, 0, 1, 1, 1, 1]], dtype=np.float64)

# Opt5v2 (node 4 in center position, LeastSquares.cpp:440)
_DATA5V2 = np.array([
    [1, 1, 0, 0, 0, 0, 0],
    [1, 0, 1, 0, 0, 1, 1],
    [1, 0, 0, 1, 0, 1, 1],
    [1, 0, 0, 0, 1, 1, 0],
    [0, 1, 1, 0, 0, 1, 1],
    [0, 1, 0, 1, 0, 1, 1],
    [0, 1, 0, 0, 1, 1, 0],
    [0, 0, 1, 1, 0, 0, 0],
    [0, 0, 1, 0, 1, 0, 1],
    [0, 0, 0, 1, 1, 0, 1]], dtype=np.float64)


def _fit_topology(data, lm, D, V, pairs):
    dists = np.array([D[lm[i], lm[j]] for i, j in pairs])
    weights = np.array([V[lm[i], lm[j]] for i, j in pairs])
    A = weights[:, None] * data
    nd = nnls(A, dists)
    fit = float(np.square(A @ nd - dists).sum())
    return fit, nd


def _local_distmatrix(g, nodes, edges, k, all_D, all_V):
    """The k-taxon weighted distance matrix around a quartet/quintet
    (LeastSquares.cpp:304-327 / 558-579)."""
    leaf_distances = [g.subtree_dist(nodes[i], edges[i]) for i in range(k)]
    D = np.zeros((k, k))
    V = np.zeros((k, k))
    for i in range(k):
        for j in range(i + 1, k):
            dd = 0.0
            vv = 0.0
            for ln_k, d_k in leaf_distances[i]:
                for ln_l, d_l in leaf_distances[j]:
                    kk, ll = ln_k.leaf, ln_l.leaf
                    dd += all_V[kk, ll] * (all_D[kk, ll] - d_k - d_l)
                    vv += all_V[kk, ll]
            D[i, j] = D[j, i] = dd
            V[i, j] = V[j, i] = vv
    V = np.sqrt(V)
    with np.errstate(divide="ignore", invalid="ignore"):
        D = D / V
    return D, V


def _opt4(lm, nodes, edges, D, V, best_fit, apply_):
    """Opt4 (LeastSquares.cpp:219-278)."""
    fit, nd = _fit_topology(_DATA4, lm, D, V, _PAIRS4)
    if fit < best_fit[0] and apply_:
        best_fit[0] = fit
        for i in range(4):
            edges[lm[i]].length = nd[i]
            edges[lm[i]].nodes[0] = nodes[lm[i]]
        edges[4].length = nd[4]
        edges[4].nodes[0] = nodes[4]
        edges[4].nodes[1] = nodes[5]
        nodes[4].edges[0] = edges[4]
        nodes[4].edges[1] = edges[lm[0]]
        nodes[4].edges[2] = edges[lm[1]]
        nodes[5].edges[0] = edges[4]
        nodes[5].edges[1] = edges[lm[2]]
        nodes[5].edges[2] = edges[lm[3]]
        edges[lm[0]].nodes[1] = nodes[4]
        edges[lm[1]].nodes[1] = nodes[4]
        edges[lm[2]].nodes[1] = nodes[5]
        edges[lm[3]].nodes[1] = nodes[5]
    return fit


def _optimize_quartet(e: Edge, g: Graph, all_D, all_V, apply_, options):
    """OptimizeQuartet (LeastSquares.cpp:281-348)."""
    if e.nodes[0].is_leaf() or e.nodes[1].is_leaf():
        e.support = _support(e.length, options)
        return

    nodes = [None] * 6
    edges = [None] * 5
    edges[4] = e
    nodes[4] = e.nodes[0]
    nodes[5] = e.nodes[1]
    edges[0] = nodes[4].edges[1] if nodes[4].edges[0] is e \
        else nodes[4].edges[0]
    edges[1] = nodes[4].edges[1] if nodes[4].edges[2] is e \
        else nodes[4].edges[2]
    edges[2] = nodes[5].edges[1] if nodes[5].edges[0] is e \
        else nodes[5].edges[0]
    edges[3] = nodes[5].edges[1] if nodes[5].edges[2] is e \
        else nodes[5].edges[2]
    nodes[0] = edges[0].other(nodes[4])
    nodes[1] = edges[1].other(nodes[4])
    nodes[2] = edges[2].other(nodes[5])
    nodes[3] = edges[3].other(nodes[5])

    D, V = _local_distmatrix(g, nodes, edges, 4, all_D, all_V)

    best_fit = [np.inf]
    f1 = _opt4((0, 1, 2, 3), nodes, edges, D, V, best_fit, apply_)
    f2 = _opt4((0, 2, 1, 3), nodes, edges, D, V, best_fit, apply_)
    f3 = _opt4((0, 3, 1, 2), nodes, edges, D, V, best_fit, apply_)

    e.support = 1.0 / (1.0 + math.exp((f2 - f1) / -2.0)
                       + math.exp((f3 - f1) / -2.0))


def _optimize_quartets(g: Graph, all_D, all_V, apply_, options):
    for e in g.edges:
        _optimize_quartet(e, g, all_D, all_V, apply_, options)


def _opt5v1(lm, nodes, edges, D, V, best_fit, apply_):
    """Opt5v1 (LeastSquares.cpp:351-436)."""
    fit, nd = _fit_topology(_DATA5V1, lm, D, V, _PAIRS5)
    if fit < best_fit[0] and apply_:
        best_fit[0] = fit
        for i in range(5):
            edges[lm[i]].length = nd[i]
            edges[lm[i]].nodes[0] = nodes[lm[i]]
        edges[5].length = nd[5]
        edges[5].nodes[0] = nodes[5]
        edges[5].nodes[1] = nodes[6]
        edges[6].length = nd[6]
        edges[6].nodes[0] = nodes[5]
        edges[6].nodes[1] = nodes[7]
        nodes[5].edges[0] = edges[5]
        nodes[5].edges[1] = edges[6]
        nodes[5].edges[2] = edges[lm[1]]
        nodes[6].edges[0] = edges[5]
        nodes[6].edges[1] = edges[lm[2]]
        nodes[6].edges[2] = edges[lm[3]]
        nodes[7].edges[0] = edges[6]
        nodes[7].edges[1] = edges[lm[0]]
        nodes[7].edges[2] = edges[lm[4]]
        edges[lm[0]].nodes[1] = nodes[7]
        edges[lm[1]].nodes[1] = nodes[5]
        edges[lm[2]].nodes[1] = nodes[6]
        edges[lm[3]].nodes[1] = nodes[6]
        edges[lm[4]].nodes[1] = nodes[7]
        nodes[5].todo = True
        nodes[6].todo = True
        nodes[7].todo = True
    return fit


def _opt5v2(lm, nodes, edges, D, V, best_fit, apply_):
    """Opt5v2 (LeastSquares.cpp:439-525)."""
    fit, nd = _fit_topology(_DATA5V2, lm, D, V, _PAIRS5)
    if fit < best_fit[0] and apply_:
        best_fit[0] = fit
        for i in range(5):
            edges[lm[i]].length = nd[i]
            edges[lm[i]].nodes[0] = nodes[lm[i]]
        edges[5].length = nd[5]
        edges[5].nodes[0] = nodes[5]
        edges[5].nodes[1] = nodes[7]
        edges[6].length = nd[6]
        edges[6].nodes[0] = nodes[6]
        edges[6].nodes[1] = nodes[7]
        nodes[5].edges[0] = edges[5]
        nodes[5].edges[1] = edges[lm[0]]
        nodes[5].edges[2] = edges[lm[1]]
        nodes[6].edges[0] = edges[6]
        nodes[6].edges[1] = edges[lm[2]]
        nodes[6].edges[2] = edges[lm[3]]
        nodes[7].edges[0] = edges[5]
        nodes[7].edges[1] = edges[6]
        nodes[7].edges[2] = edges[lm[4]]
        edges[lm[0]].nodes[1] = nodes[5]
        edges[lm[1]].nodes[1] = nodes[5]
        edges[lm[2]].nodes[1] = nodes[6]
        edges[lm[3]].nodes[1] = nodes[6]
        edges[lm[4]].nodes[1] = nodes[7]
        nodes[5].todo = True
        nodes[6].todo = True
        nodes[7].todo = False
    return fit


_QUINTET_SCHEDULE = [
    ("v2", (0, 1, 2, 3, 4)),
    ("v1", (0, 1, 2, 3, 4)),
    ("v1", (1, 0, 2, 3, 4)),
    ("v1", (2, 3, 0, 1, 4)),
    ("v1", (3, 2, 0, 1, 4)),
    ("v2", (0, 2, 1, 3, 4)),
    ("v1", (0, 2, 1, 3, 4)),
    ("v1", (2, 0, 1, 3, 4)),
    ("v1", (1, 3, 0, 2, 4)),
    ("v1", (3, 1, 0, 2, 4)),
    ("v2", (0, 3, 1, 2, 4)),
    ("v1", (0, 3, 1, 2, 4)),
    ("v1", (3, 0, 1, 2, 4)),
    ("v1", (1, 2, 0, 3, 4)),
    ("v1", (2, 1, 0, 3, 4)),
]


def _optimize_quintet(n: Node, e: Edge, g: Graph, all_D, all_V, apply_
                      ) -> bool:
    """OptimizeQuintet (LeastSquares.cpp:528-630): n is the center node,
    e leads to the 5th subtree."""
    nodes = [None] * 8
    edges = [None] * 7
    edges[4] = e
    nodes[7] = n
    nodes[4] = edges[4].other(n)

    if nodes[7].is_leaf():
        return False
    edges[5] = nodes[7].edges[1] if nodes[7].edges[0] is e \
        else nodes[7].edges[0]
    edges[6] = nodes[7].edges[1] if nodes[7].edges[2] is e \
        else nodes[7].edges[2]
    nodes[5] = edges[5].other(nodes[7])
    nodes[6] = edges[6].other(nodes[7])
    if nodes[5].is_leaf() or nodes[6].is_leaf():
        return False
    edges[0] = nodes[5].edges[1] if nodes[5].edges[0] is edges[5] \
        else nodes[5].edges[0]
    edges[1] = nodes[5].edges[1] if nodes[5].edges[2] is edges[5] \
        else nodes[5].edges[2]
    edges[2] = nodes[6].edges[1] if nodes[6].edges[0] is edges[6] \
        else nodes[6].edges[0]
    edges[3] = nodes[6].edges[1] if nodes[6].edges[2] is edges[6] \
        else nodes[6].edges[2]
    nodes[0] = edges[0].other(nodes[5])
    nodes[1] = edges[1].other(nodes[5])
    nodes[2] = edges[2].other(nodes[6])
    nodes[3] = edges[3].other(nodes[6])

    D, V = _local_distmatrix(g, nodes, edges, 5, all_D, all_V)

    best_fit = [np.inf]
    f1 = None
    for kind, lm in _QUINTET_SCHEDULE:
        fn = _opt5v2 if kind == "v2" else _opt5v1
        fit = fn(lm, nodes, edges, D, V, best_fit, apply_)
        if f1 is None:
            f1 = fit
    return best_fit[0] < f1


def _optimize_quintets(g: Graph, all_D, all_V, apply_):
    """OptimizeQuintets (LeastSquares.cpp:632-652)."""
    for n in g.nodes:
        n.todo = True
    for _ in range(MAX_ITERS5):
        any_ = False
        for n in g.nodes:
            if not n.todo:
                continue
            n.todo = False
            if n.is_leaf():
                continue
            for e in n.edges:
                if _optimize_quintet(n, e, g, all_D, all_V, apply_):
                    any_ = True
                    break
        if not any_:
            break


def refine_tree(tree: PhyTree, leaf_order: List[str], distances: np.ndarray,
                variances: np.ndarray, options) -> PhyTree:
    """LeastSquares::refineTree (LeastSquares.cpp:661-711)."""
    g = Graph(tree, leaf_order)
    with np.errstate(divide="ignore"):
        var_inv = 1.0 / np.asarray(variances, dtype=np.float64)
    D = np.asarray(distances, dtype=np.float64)

    _optimize_quartets(g, D, var_inv, True, options)
    fit2 = compute_fit(g, D, var_inv)

    i = 0
    while True:
        fit1 = fit2
        if options.wlsrefine_flag > 1:
            _optimize_quintets(g, D, var_inv, True)
            fit2 = compute_fit(g, D, var_inv)
        _optimize_quartets(g, D, var_inv, True, options)
        fit2 = compute_fit(g, D, var_inv)
        i += 1
        if not (fit2 < fit1 and i < MAX_ITERS):
            break

    # compute support only
    _optimize_quartets(g, D, var_inv, False, options)
    return g.to_tree()
