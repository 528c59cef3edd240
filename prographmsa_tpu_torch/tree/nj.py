"""BioNJ guide-tree construction (Gascuel 1997).

Behavioral parity with TreeNJ.cpp:132-281 — including
Eigen's column-major first-minimum tie-breaking in the Q-matrix argmin, the
variance-weighted lambda, the reduction bookkeeping (deleted index2, new node
at index1), and the 2-/3-leaf terminations.  The native library's
``gc_bionj`` runs the loop's steps, every operation in the numpy loop's
order, and Python replays its joins; the numpy loop below is the path
without the library.
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
from ..errors import ParityError

from .phytree import PhyTree
from .. import native
from ..eigen_compat import eigen_colwise_sum, eigen_seq_sum

MIN_DIST = 1e-4
MIN_VAR = 1e-5


def support(d: float, options) -> float:
    """Branch support = edge half-life decay (TreeNJ.cpp:22-29)."""
    s = 1.0 - math.exp(-math.log(2.0) * d / options.edge_halflife)
    s = min(1.0, max(0.0, s))
    if s != s:
        s = 0.0
    return s


def build_topo_plan(seqs_order: List[str], topo: PhyTree) -> List[tuple]:
    """Turn a user topology into a forced join schedule (TreeNJ.cpp:31-130)."""
    orig_leaf_index = {name: i for i, name in enumerate(seqs_order)}
    seq_in_tree = [False] * len(seqs_order)
    my_leaf_index = {}
    n_children_ready = {}
    n_children_valid = {}
    INVALID = -1

    def init(node: PhyTree):
        if not node.is_leaf():
            n_children_ready[id(node)] = 0
            n_children_valid[id(node)] = 0
            for child in node.children:
                init(child)
                n_children_valid[id(node)] += n_children_valid.get(
                    id(child), 1 if child.is_leaf() and
                    my_leaf_index.get(id(child), INVALID) != INVALID else 0)
                n_children_ready[id(node)] += 1 if child.is_leaf() else 0
        else:
            pos = orig_leaf_index.get(node.name)
            if pos is not None:
                my_leaf_index[id(node)] = pos
                n_children_valid[id(node)] = 1
                seq_in_tree[pos] = True
            else:
                my_leaf_index[id(node)] = INVALID
                n_children_valid[id(node)] = 0

    init(topo)
    for i, ok in enumerate(seq_in_tree):
        if not ok:
            raise ParityError('sequence "%s" is missing in given topology'
                             % seqs_order[i])

    plan = []
    worklist = [node for node in _all_internal(topo)
                if n_children_ready.get(id(node), -1) == node.n_children()]
    while worklist:
        node = worklist.pop(0)
        assert node.n_children() == 2
        c1, c2 = node.children
        i1 = my_leaf_index.pop(id(c1))
        i2 = my_leaf_index.pop(id(c2))
        if i1 == -1:
            my_leaf_index[id(node)] = i2
        elif i2 == -1:
            my_leaf_index[id(node)] = i1
        else:
            if i1 > i2:
                i1, i2 = i2, i1
            my_leaf_index[id(node)] = i1
            plan.append((i1, i2))
            for k in list(my_leaf_index):
                if my_leaf_index[k] > i2 and my_leaf_index[k] != -1:
                    my_leaf_index[k] -= 1
        parent = node.parent
        if parent is not None:
            n_children_ready[id(parent)] = n_children_ready.get(id(parent), 0) + 1
            if n_children_ready[id(parent)] == parent.n_children():
                worklist.append(parent)
    return plan


def _all_internal(tree: PhyTree):
    out = []

    def rec(n):
        if not n.is_leaf():
            out.append(n)
            for c in n.children:
                rec(c)
    rec(tree)
    return out


def _join(seqs_order: List[str], subtrees: List[PhyTree], index1: int,
          index2: int, dist1: float, dist2: float, options) -> None:
    """Join subtrees index1 < index2 into a new node that takes index1's
    place (TreeNJ.cpp's reduction bookkeeping)."""
    name1 = seqs_order[index1]
    name2 = seqs_order[index2]
    del seqs_order[index2]
    seqs_order[index1] = name1 + "," + name2

    tree = PhyTree(seqs_order[index1])
    tree.add_child(subtrees[index1], dist1, support(dist1, options))
    tree.add_child(subtrees[index2], dist2, support(dist2, options))
    del subtrees[index2]
    subtrees[index1] = tree


def build_nj_tree(seqs_order: List[str], distances: np.ndarray,
                  variances: np.ndarray, options,
                  topo: Optional[PhyTree] = None) -> PhyTree:
    seqs_order = list(seqs_order)
    D = np.array(distances, dtype=np.float64)
    V = np.array(variances, dtype=np.float64)
    topo_plan = build_topo_plan(seqs_order, topo) if topo is not None else []
    plan_pos = 0

    subtrees = [PhyTree(name) for name in seqs_order]

    dim = len(seqs_order)
    joined = native.bionj_native(D, V, topo_plan) if dim > 3 else None
    if joined is not None:
        joins, lengths, D = joined
        for (index1, index2), (dist1, dist2) in zip(joins.tolist(), lengths):
            _join(seqs_order, subtrees, index1, index2, dist1, dist2, options)
        dim = 3
    while dim > 3:
        D = np.maximum(D, MIN_DIST)
        V = np.maximum(V, MIN_VAR)
        np.fill_diagonal(D, 0.0)
        np.fill_diagonal(V, 0.0)

        sums = eigen_colwise_sum(D)

        if plan_pos >= len(topo_plan):
            # Q-matrix selection with Eigen column-major first-min
            # tie-breaking (TreeNJ.cpp:159-174)
            Q = 0.5 * D - (0.5 / (dim - 2.0)) * (sums[None, :] + sums[:, None])
            np.fill_diagonal(Q, np.inf)
            # Eigen minCoeff(&index2,&index1) visits column-major and keeps
            # the first minimum; index2 receives the row, index1 the column.
            flat = int(np.argmin(Q.flatten(order="F")))
            index2 = flat % dim   # row
            index1 = flat // dim  # col
            if index2 < index1:
                index1, index2 = index2, index1
        else:
            index1, index2 = topo_plan[plan_pos]
            plan_pos += 1

        dist1 = (D[index1, index2] + (sums[index1] - sums[index2])
                 / (dim - 2.0)) / 2.0
        dist1 = min(max(dist1, MIN_DIST), D[index1, index2])
        dist2 = max(D[index2, index1] - dist1, MIN_DIST)

        # BioNJ variance-weighted averaging (TreeNJ.cpp:204-215)
        lam = 0.5 + eigen_seq_sum(V[index2, :] - V[index1, :]) / (
            2.0 * (dim - 2) * V[index1, index2])
        if lam != lam:
            lam = 0.5
        else:
            lam = min(max(0.0, lam), 1.0)

        new_dist = lam * (D[index1, :] - dist1) + (1.0 - lam) * (D[index2, :] - dist2)
        new_var = (lam * V[index1, :] + (1.0 - lam) * V[index2, :]
                   - lam * (1.0 - lam) * V[index1, index2])
        new_dist[index1] = 0.0
        new_var[index1] = 0.0
        new_dist = np.delete(new_dist, index2)
        new_var = np.delete(new_var, index2)

        D = np.delete(np.delete(D, index2, axis=0), index2, axis=1)
        V = np.delete(np.delete(V, index2, axis=0), index2, axis=1)
        D[index1, :] = new_dist
        D[:, index1] = new_dist
        V[index1, :] = new_var
        V[:, index1] = new_var

        _join(seqs_order, subtrees, index1, index2, dist1, dist2, options)
        dim -= 1

    tree = PhyTree("root")
    if len(seqs_order) == 2:
        d = D[0, 1] / 2.0
        tree.add_child(subtrees[0], d, support(d, options))
        tree.add_child(subtrees[1], d, support(d, options))
    else:
        assert len(seqs_order) == 3
        d0 = (D[0, 1] + D[0, 2] - D[1, 2]) / 2.0
        d0 = min(max(d0, MIN_DIST), min(D[1, 0], D[2, 0]))
        d1 = max(D[1, 0] - d0, MIN_DIST)
        d2 = max(D[2, 0] - d0, MIN_DIST)

        tree2 = PhyTree("root2")
        tree2.add_child(subtrees[0], d0, support(d0, options))
        tree2.add_child(subtrees[1], d1, support(d1, options))

        tree.add_child(subtrees[2], d2 / 2.0, support(d2, options))
        tree.add_child(tree2, d2 / 2.0, support(d2, options))

    return tree
