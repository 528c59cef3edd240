"""Rooted phylogenetic tree ADT.

Behavioral parity with PhyTree.{h,cpp}: branch lengths and
branch supports live on the child edge; ``format_newick`` prints with C++
default ostream precision (6 significant digits); ``midpoint_root`` re-hangs
the tree halfway along the longest leaf-leaf path (PhyTree.cpp:60-116);
``get_tree_order`` yields the output ordering incl. ancestral-name
interleaving (PhyTree.cpp:118-183).
"""

from __future__ import annotations

import math
from typing import List, Optional
from ..errors import ParityError


def _fmt(x: float) -> str:
    """C++ `ostream << double` default formatting (6 significant digits)."""
    if x != x:
        return "nan"
    if x == float("inf"):
        return "inf"
    if x == float("-inf"):
        return "-inf"
    s = "%.6g" % x
    return s


class PhyTree:
    __slots__ = ("children", "parent", "branch_length", "branch_support", "name")

    def __init__(self, name: str = ""):
        self.children: List["PhyTree"] = []
        self.parent: Optional["PhyTree"] = None
        self.branch_length: float = 0.0
        self.branch_support: float = 1.0
        self.name = name

    # ------------------------------------------------------------------
    def copy(self) -> "PhyTree":
        out = PhyTree(self.name)
        out.branch_length = self.branch_length
        out.branch_support = self.branch_support
        for c in self.children:
            out.add_child(c.copy(), c.branch_length, c.branch_support)
        return out

    def add_child(self, child: "PhyTree", branch_length: float = 0.0,
                  branch_support: float = 1.0) -> None:
        assert child is not self and child.parent is None
        self.children.append(child)
        child.parent = self
        child.branch_length = branch_length
        child.branch_support = branch_support

    def index_of(self) -> int:
        return self.parent.children.index(self)

    def pluck(self) -> None:
        assert self.parent is not None
        self.parent.children.remove(self)
        self.parent = None
        self.branch_length = 0.0
        self.branch_support = 1.0

    def pluck_child(self, index: int) -> "PhyTree":
        child = self.children.pop(index)
        child.parent = None
        child.branch_length = 0.0
        self.branch_support = 1.0   # parity: reference resets *self* support here
        return child

    def fix_distances(self, options) -> None:
        """Clamp branch lengths (PhyTree.h:27-38,141-145)."""
        def rec(node: "PhyTree") -> None:
            if options.mldist_flag or options.mldist_gap_flag:
                if math.isnan(node.branch_length):
                    node.branch_length = options.max_dist
                node.branch_length = min(max(options.min_dist, node.branch_length),
                                         options.max_dist)
            else:
                if math.isnan(node.branch_length):
                    node.branch_length = options.max_pdist
                node.branch_length = min(max(options.min_pdist, node.branch_length),
                                         options.max_pdist)
            for c in node.children:
                rec(c)
        for c in self.children:
            rec(c)

    def count_leaves(self) -> int:
        if self.is_leaf():
            return 1
        return sum(c.count_leaves() for c in self.children)

    def is_leaf(self) -> bool:
        return not self.children

    def n_children(self) -> int:
        return len(self.children)

    def __getitem__(self, i: int) -> "PhyTree":
        return self.children[i]

    # ------------------------------------------------------------------
    def _format_newick_r(self) -> str:
        if self.is_leaf():
            return self.name
        parts = ["%s:%s" % (c._format_newick_r(), _fmt(c.branch_length))
                 for c in self.children]
        return "(" + ",".join(parts) + ")"

    def format_newick(self) -> str:
        return self._format_newick_r() + ";"

    def __repr__(self):
        return "PhyTree(%s)" % self.format_newick()


# ----------------------------------------------------------------------
# midpoint rooting (PhyTree.cpp:11-116)
# ----------------------------------------------------------------------

def _max_dist_pair_r(root: PhyTree, state: dict):
    if not root.is_leaf():
        if root.n_children() != 2:
            raise ParityError("multifurcations not supported")
        d1, l1 = _max_dist_pair_r(root[0], state)
        d2, l2 = _max_dist_pair_r(root[1], state)
        d1 = [d + root[0].branch_length for d in d1]
        d2 = [d + root[1].branch_length for d in d2]
        for i, di in enumerate(d1):
            for j, dj in enumerate(d2):
                if di + dj > state["max_dist"]:
                    state["max_dist"] = di + dj
                    state["max"] = l1[i] if di > dj else l2[j]
        return d1 + d2, l1 + l2
    return [0.0], [root]


def midpoint_root(root: PhyTree) -> PhyTree:
    state = {"max": None, "max_dist": -math.inf}
    _max_dist_pair_r(root, state)
    dist = state["max_dist"]
    current = state["max"]
    assert current is not None

    dist /= 2.0
    while current is not root and dist - current.branch_length > 0:
        dist -= current.branch_length
        current = current.parent
    if current is root:
        return root

    new_root = PhyTree("new_root")
    current_dist = current.branch_length - dist
    current_support = current.branch_support
    parent = current.parent

    current.pluck()
    new_root.add_child(current, dist, current_support)
    current = new_root

    while parent is not root:
        new_dist = parent.branch_length
        new_support = parent.branch_support
        new_parent = parent.parent

        parent.pluck()
        current.add_child(parent, current_dist, current_support)

        current = parent
        parent = new_parent
        current_dist = new_dist
        current_support = new_support

    assert root.n_children() == 1
    current_dist += root[0].branch_length
    current_support = max(current_support, root[0].branch_support)
    other = root.pluck_child(0)
    current.add_child(other, current_dist, current_support)

    return new_root


# ----------------------------------------------------------------------
# output ordering (PhyTree.cpp:118-183)
# ----------------------------------------------------------------------

def _list_to_name(leaves: List[str]) -> str:
    names = sorted(leaves)
    return "(" + ",".join(n for n in names if not n.startswith("(")) + ")"


def get_tree_order_ancestral(tree: PhyTree) -> List[str]:
    order: List[str] = []
    if tree.is_leaf():
        order.append(tree.name)
    else:
        for i, child in enumerate(tree.children):
            subtree_order = get_tree_order_ancestral(child)
            pos = len(order)
            order[pos:pos] = subtree_order
            if i != 0:
                order.insert(pos, _list_to_name(order))
    return order


def get_tree_order(tree: PhyTree, options) -> List[str]:
    if options.ancestral_flag:
        return get_tree_order_ancestral(tree)
    order: List[str] = []

    def rec(node: PhyTree) -> None:
        if node.is_leaf():
            order.append(node.name)
        else:
            for c in node.children:
                rec(c)
    rec(tree)
    return order
