"""Root search (-r exhaustive / -r -r greedy hill-climb).

Re-derivation of FindRoot.{h,cpp}, the port's copy of
prographmsa_tpu/engine/find_root.py: the rooted guide tree becomes an
unrooted node/edge graph; every candidate root edge yields a full
progressive alignment assembled from per-node *directional* caches (each
internal node caches up to 3 subtree alignments, one per incident edge,
FindRoot.h:93-133), so successive roots only recompute alignments not shared
with already-evaluated roots.  The best root minimizes gap parsimony.

Parity quirks reproduced on purpose:
* FindRoot.cpp declares an AA specialization of tree2graph (with CS-profile
  leaf handling and *without* copying branch support) — but tree2graph is a
  ``static`` function template in the header, so that specialization lives
  only in FindRoot.cpp's own translation unit and is DEAD CODE: main.cpp
  instantiates the generic template (verified against an instrumented
  from-source build: supports are real values, and the shipped binary's
  -r output matches the generic path byte-for-byte).  Hence: supports are
  always copied, and CS profiles are IGNORED for find-root leaves
  (FindRoot.h:173 ``(void)csprofile``).
* Leaf results carry no ``profiles`` entries (unlike progressive_alignment
  leaves, ProgressiveAlignment.h:73).

``Node.get_alignment`` / ``Edge.get_alignment`` are the reference's lazy
recursion, the port's sequential oracle.  The search itself fills the
caches first with ``BatchedRootSearch.align_edges``: the directional
alignments an edge set needs, wave by wave (a wave is every missing
alignment whose two inputs are cached), then the edges' root alignments,
each wave one batch of engine/level_driver.py's ``align_tasks`` (the
device DP when ``device`` is given).  Each alignment is a pure function of
its inputs, so the caches equal the recursion's; the TR lines
(--repeats) are printed afterwards by walking the recursion over the
caches, in the order the recursion computes them.
"""

from __future__ import annotations

import sys
from typing import List

import numpy as np
from ..errors import ParityError

from .. import timings
from .gap_parsimony import score_alignments
from .level_driver import HostPool, align_tasks
from .progressive import (ProgressiveAlignmentResult,
                          align_progressive_results,
                          create_ancestral_seq_name, sequence_graph)

_DIR_OTHERS = {0: (1, 2), 1: (0, 2), 2: (0, 1)}


class Node:
    __slots__ = ("edges", "cached", "n_tr", "name")

    def __init__(self):
        self.edges: List = [None, None, None]
        self.cached: List = [None, None, None]
        self.n_tr: List = [None, None, None]   # TR indels of each slot's
        self.name = ""                         # own alignment

    def is_leaf(self) -> bool:
        return self.edges[1] is None

    def index(self, e) -> int:
        return next(i for i in range(3) if self.edges[i] is e)

    def inputs(self, index):
        """The two (node, edge) whose alignments toward this node the slot
        ``index`` aligns."""
        e1, e2 = (self.edges[i] for i in _DIR_OTHERS[index])
        return (e1.other(self), e1), (e2.other(self), e2)

    def get_alignment(self, e, factory, options, spec):
        """FindRoot::node::getAlignment (FindRoot.h:93-133)."""
        index = self.index(e)
        if self.cached[index] is None:
            assert not self.is_leaf()
            (n1, e1), (n2, e2) = self.inputs(index)
            r1 = n1.get_alignment(e1, factory, options, spec)
            r2 = n2.get_alignment(e2, factory, options, spec)
            self.cached[index] = align_progressive_results(
                r1, r2, e1.length, e2.length, e1.support, e2.support,
                factory, options, spec)
        return self.cached[index]


class Edge:
    __slots__ = ("alignment", "n_tr", "nodes", "length", "support")

    def __init__(self):
        self.alignment = None
        self.n_tr = None
        self.nodes: List = [None, None]
        self.length = -1.0
        self.support = -1.0

    def other(self, n: Node) -> Node:
        return self.nodes[1] if self.nodes[0] is n else self.nodes[0]

    def get_alignment(self, factory, options, spec):
        """FindRoot::edge::getAlignment (FindRoot.h:136-147): the root
        splits this edge's length 50/50."""
        if self.alignment is None:
            r1 = self.nodes[0].get_alignment(self, factory, options, spec)
            r2 = self.nodes[1].get_alignment(self, factory, options, spec)
            self.alignment = align_progressive_results(
                r1, r2, self.length / 2, self.length / 2, self.support,
                self.support, factory, options, spec)
        return self.alignment


def _leaf_result(spec, name, tree_bl, sequences, repeats, csprofile,
                 factory, options) -> ProgressiveAlignmentResult:
    """Leaf setup (FindRoot.h:175-196; the generic template ignores
    csprofile — see module docstring)."""
    del tree_bl, csprofile
    if name not in sequences:
        raise ParityError("unknown sequence name: %s" % name)
    seq = sequences[name]
    res = ProgressiveAlignmentResult()
    res.is_csprofile = False
    res.graph = sequence_graph(spec, seq)

    if name in repeats:
        for rep in repeats[name]:
            tr_hom = np.full(res.graph.size, -1, dtype=np.int64)
            tr_hom[rep.start + 1:rep.start + 1 + len(rep.tr_hom)] = \
                rep.tr_hom
            res.tr_homologies.append(tr_hom)
            res.tr_source.append(name)
        res.graph.add_repeats(res.tr_homologies)

    res.aligned_sequences[name] = seq
    res.score = 0.0
    res.n_tr_indels = 0
    return res


def _tree2graph(spec, current: Node, tree, nodes, edges, sequences, repeats,
                csprofile, factory, options):
    """FindRoot::tree2graph (FindRoot.h:170-231; AA spec. FindRoot.cpp)."""
    current.name = tree.name
    if tree.is_leaf():
        current.cached[0] = _leaf_result(spec, current.name,
                                         tree.branch_length, sequences,
                                         repeats, csprofile, factory,
                                         options)
        return
    assert tree.n_children() == 2
    for slot, child in ((1, tree[0]), (2, tree[1])):
        e = Edge()
        edges.append(e)
        e.length = child.branch_length
        e.support = child.branch_support
        current.edges[slot] = e
        n = Node()
        nodes.append(n)
        n.edges[0] = e
        e.nodes[0] = current
        e.nodes[1] = n
        _tree2graph(spec, n, child, nodes, edges, sequences, repeats,
                    csprofile, factory, options)


def tree_graph(spec, sequences, tree, repeats, csprofile, factory, options):
    """The unrooted node/edge graph of ``tree`` with the leaves' results
    cached (FindRoot.h:234-274); returns (nodes, edges)."""
    nodes: List[Node] = []
    edges: List[Edge] = []

    if tree.n_children() == 2:
        e0 = Edge()
        edges.append(e0)
        e0.length = tree[0].branch_length + tree[1].branch_length
        e0.support = max(tree[0].branch_support, tree[1].branch_support)
        n0 = Node()
        nodes.append(n0)
        n0.edges[0] = e0
        e0.nodes[0] = n0
        n1 = Node()
        nodes.append(n1)
        n1.edges[0] = e0
        e0.nodes[1] = n1
        _tree2graph(spec, n0, tree[0], nodes, edges, sequences, repeats,
                    csprofile, factory, options)
        _tree2graph(spec, n1, tree[1], nodes, edges, sequences, repeats,
                    csprofile, factory, options)
    elif tree.n_children() == 3:
        n0 = Node()
        nodes.append(n0)
        for i in range(3):
            ei = Edge()
            edges.append(ei)
            ei.length = tree[i].branch_length
            ei.support = tree[i].branch_support
            ni = Node()
            nodes.append(ni)
            ni.edges[0] = ei
            ei.nodes[0] = n0
            ei.nodes[1] = ni
            n0.edges[i] = ei
            _tree2graph(spec, ni, tree[i], nodes, edges, sequences, repeats,
                        csprofile, factory, options)
    else:
        raise ParityError("multifurcations not allowed")
    return nodes, edges


class BatchedRootSearch:
    """Fills the caches of a tree graph in batches: ``align_edges(edges)``
    computes what ``e.get_alignment`` would for each ``e``, wave by wave
    through ``align_tasks``, and then prints the TR lines (--repeats) that
    the recursion would have printed, in its order."""

    def __init__(self, factory, options, spec, device, engine, pool,
                 mesh=None):
        self.factory, self.options, self.spec = factory, options, spec
        self.device, self.engine, self.pool = device, engine, pool
        self.mesh = mesh
        self.printed = set()

    def _align(self, tasks):
        return align_tasks(tasks, self.factory, self.options, self.spec,
                           self.device, self.engine, self.pool, self.mesh)

    def align_edges(self, edges):
        missing, seen = [], set()

        def need(n, e):
            i = n.index(e)
            if n.cached[i] is not None or (id(n), i) in seen:
                return
            seen.add((id(n), i))
            for dn, de in n.inputs(i):
                need(dn, de)
            missing.append((n, i))

        for e in edges:
            for n in e.nodes:
                need(n, e)
        while missing:
            wave = [t for t in missing
                    if all(dn.cached[dn.index(de)] is not None
                           for dn, de in t[0].inputs(t[1]))]
            if not wave:
                raise ParityError("find-root wave scheduling stuck")
            tasks = []
            for n, i in wave:
                (n1, e1), (n2, e2) = n.inputs(i)
                tasks.append((n1.cached[n1.index(e1)],
                              n2.cached[n2.index(e2)], e1.length, e2.length,
                              e1.support, e2.support))
            for (n, i), (res, ntr) in zip(wave, self._align(tasks)):
                n.cached[i], n.n_tr[i] = res, ntr
            done = set(map(id, wave))
            missing = [t for t in missing if id(t) not in done]

        roots = [e for e in edges if e.alignment is None]
        if roots:
            tasks = [(e.nodes[0].cached[e.nodes[0].index(e)],
                      e.nodes[1].cached[e.nodes[1].index(e)],
                      e.length / 2, e.length / 2, e.support, e.support)
                     for e in roots]
            for e, (res, ntr) in zip(roots, self._align(tasks)):
                e.alignment, e.n_tr = res, ntr
        if self.options.repeats_flag:
            for e in edges:
                self._print_edge(e)

    def _print(self, key, result, n_tr):
        self.printed.add(key)
        print("TR indels at %s: %d"
              % (create_ancestral_seq_name(result.aligned_sequences), n_tr),
              file=sys.stderr)

    def _print_node(self, n, e):
        """The lines of ``n.get_alignment(e)``'s recursion."""
        i = n.index(e)
        if n.is_leaf() or (id(n), i) in self.printed:
            return
        for dn, de in n.inputs(i):
            self._print_node(dn, de)
        self._print((id(n), i), n.cached[i], n.n_tr[i])

    def _print_edge(self, e):
        """The lines of ``e.get_alignment()``'s recursion."""
        if id(e) in self.printed:
            return
        self._print_node(e.nodes[0], e)
        self._print_node(e.nodes[1], e)
        self._print(id(e), e.alignment, e.n_tr)


def progressive_alignment_find_root(spec, sequences, tree, repeats,
                                    csprofile, factory, options, device=None,
                                    engine: str = "torch", mesh=None
                                    ) -> ProgressiveAlignmentResult:
    """FindRoot.h:234-337, with every alignment batched through
    ``BatchedRootSearch`` (``device``/``engine``/``mesh`` as in the level
    scheduler): ``-r`` computes all edges' alignments, ``-r -r`` the edges
    each step of its hill climb reads; each such set is scored in one
    ``score_alignments`` pass (``--timings`` phase ``root_score``)."""
    _nodes, edges = tree_graph(spec, sequences, tree, repeats, csprofile,
                               factory, options)
    gap_code = spec.gap_code
    with HostPool() as pool:
        search = BatchedRootSearch(factory, options, spec, device, engine,
                                   pool, mesh)
        if options.reroot_flag == 1:
            search.align_edges(edges)
        else:
            search.align_edges(edges[:1])

        if options.reroot_flag == 1:
            # every edge scored in one pass; the first of equal scores wins
            with timings.phase("root_score"):
                scores = score_alignments(edges, gap_code)
            best = min(range(len(edges)), key=scores.__getitem__)
            best_result = edges[best].alignment
            best_score = scores[best]
        else:
            # heuristic: hill-climb over edges adjacent to the current best
            # (FindRoot.h:291-320); a step's edges are fixed by its start,
            # so they are aligned and scored in one go, then compared in
            # order
            best_result = edges[0].alignment
            with timings.phase("root_score"):
                best_score = score_alignments(edges[:1], gap_code)[0]
            best_node = None
            best_edge = edges[0]
            while True:
                old_edge = best_edge
                old_node = best_node
                step = [(n, e) for n in old_edge.nodes if n is not old_node
                        for e in n.edges
                        if e is not old_edge and e is not None]
                search.align_edges([e for _n, e in step])
                with timings.phase("root_score"):
                    scores = score_alignments([e for _n, e in step],
                                              gap_code)
                for (n, e), score in zip(step, scores):
                    if score < best_score:
                        best_result = e.alignment
                        best_edge = e
                        best_score = score
                        best_node = n
                if best_edge is old_edge:
                    break

    print("best gap parsimony score: %s" % _fmt_score(best_score),
          file=sys.stderr)
    return best_result


def _fmt_score(score: int) -> str:
    # the reference streams a double; integral values print bare
    return "%g" % float(score)
