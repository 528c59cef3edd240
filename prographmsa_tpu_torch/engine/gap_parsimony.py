"""Gap-parsimony scoring of alignments rooted at unrooted-graph edges.

Re-derivation of GapParsimony.h: per column a 2-state (character/gap)
Fitch parsimony over the unrooted tree.  The reference packs 2 bits per
column into unsigned longs and counts conflicts with popcount
(GapParsimony.h:36-92) and scores one alignment at a time by recursion from
its root edge (:94-118).  Here a batch of alignments is scored in one pass:
each column is a bit of two planes (character, gap), 64 columns a uint64
word, the alignments side by side along the words, and the internal nodes
are combined level by level over all of them at once.

Fitch's length is the same for every rooting of an unrooted binary tree: the
root edge only decides where the last combination happens.  So one schedule,
from one fixed rooting of the tree graph, scores the alignment of every
candidate root; only the columns differ from edge to edge.
"""

from __future__ import annotations

from itertools import groupby
from typing import List

import numpy as np

# alignments packed into one pass while their words stay within this many
# (rows x words x 8 bytes x 2 planes: 16 MB at a thousand rows; all of
# fam500's 997 root alignments at once would take 512 MB, and ran slower)
_CHUNK_WORDS = 1024


class _Schedule:
    """One rooting of a tree graph: ``leaves`` (row i is leaf i),
    ``levels`` (per height, the first row and the two child rows of each
    internal node of that height) and ``root`` (the rows at the two ends
    of the rooting edge)."""

    def __init__(self, root_edge):
        pre = [(n, root_edge) for n in root_edge.nodes]
        order = []
        while pre:
            n, e = pre.pop()
            order.append((n, e))
            if not n.is_leaf():
                pre.extend((c.other(n), c) for c in n.edges if c is not e)
        height, kids, row, self.leaves, internal = {}, {}, {}, [], []
        for n, e in reversed(order):     # children before parents
            if n.is_leaf():
                height[id(n)] = 0
                row[id(n)] = len(self.leaves)
                self.leaves.append(n.name)
                continue
            ks = [c.other(n) for c in n.edges if c is not e]
            kids[id(n)] = ks
            height[id(n)] = 1 + max(height[id(k)] for k in ks)
            internal.append(n)
        internal.sort(key=lambda n: height[id(n)])
        for i, n in enumerate(internal):
            row[id(n)] = len(self.leaves) + i
        self.levels, lo = [], len(self.leaves)
        for _h, level in groupby(internal, key=lambda n: height[id(n)]):
            level = list(level)
            k1, k2 = (np.array([row[id(kids[id(n)][s])] for n in level],
                               dtype=np.intp) for s in (0, 1))
            self.levels.append((lo, k1, k2))
            lo += len(level)
        self.n_rows = lo
        self.root = tuple(row[id(n)] for n in root_edge.nodes)


def _gap_words(alignments, leaves, gap_code):
    """The gap plane of ``alignments``' leaf rows, one block of whole
    uint64 words each (padding reads as character), and each block's first
    word."""
    widths = [len(a.aligned_sequences[leaves[0]]) for a in alignments]
    start = np.zeros(len(alignments) + 1, dtype=np.intp)
    np.cumsum([(w + 63) // 64 for w in widths], out=start[1:])
    gap = np.zeros((len(leaves), 8 * int(start[-1])), dtype=np.uint8)
    # one flat copy of the rows into buffers reused across the alignments
    # (np.stack's per-row views, and a fresh buffer's page faults, cost
    # more than the copy itself)
    rows = np.empty(len(leaves) * max(widths), dtype=np.int16)
    is_gap = np.empty(rows.size, dtype=bool)
    for a, w, s in zip(alignments, widths, start):
        n = len(leaves) * w
        np.concatenate([a.aligned_sequences[x] for x in leaves],
                       out=rows[:n])
        np.equal(rows[:n], gap_code, out=is_gap[:n])
        packed = np.packbits(is_gap[:n].reshape(len(leaves), w), axis=1,
                             bitorder="little")
        gap[:, 8 * s:8 * s + packed.shape[1]] = packed
    return gap.view(np.uint64), start


def _fitch(schedule, gap):
    """Conflicts per word of the two-state Fitch pass over ``gap`` (the
    leaves' gap words), summed over the nodes and the root edge."""
    char = np.empty((schedule.n_rows, gap.shape[1]), dtype=np.uint64)
    gaps = np.empty_like(char)
    n = len(schedule.leaves)
    gaps[:n] = gap
    np.invert(gap, out=char[:n])
    conflicts = np.zeros(gap.shape[1], dtype=np.int64)
    for lo, k1, k2 in schedule.levels:
        c = char[k1] & char[k2]
        g = gaps[k1] & gaps[k2]
        # a conflict (empty intersection) takes the union: c | ~(c | g)
        # is c | ~g
        conflicts += np.bitwise_count(~(c | g)).sum(axis=0, dtype=np.int64)
        np.bitwise_or(c, ~g, out=char[lo:lo + len(k1)])
        np.bitwise_or(g, ~c, out=gaps[lo:lo + len(k1)])
    a, b = schedule.root
    conflicts += np.bitwise_count(~((char[a] & char[b]) |
                                    (gaps[a] & gaps[b])))
    return conflicts


def _score(alignments, root_edge, gap_code) -> List[int]:
    schedule = _Schedule(root_edge)
    words = [(len(a.aligned_sequences[schedule.leaves[0]]) + 63) // 64
             for a in alignments]
    scores: List[int] = []
    i = 0
    while i < len(alignments):
        j = i + 1
        while j < len(alignments) and sum(words[i:j + 1]) <= _CHUNK_WORDS:
            j += 1
        gap, start = _gap_words(alignments[i:j], schedule.leaves, gap_code)
        total = np.zeros(gap.shape[1] + 1, dtype=np.int64)
        np.cumsum(_fitch(schedule, gap), out=total[1:])
        scores.extend(int(x) for x in total[start[1:]] - total[start[:-1]])
        i = j
    return scores


def score_alignments(edges, gap_code) -> List[int]:
    """For each edge, ``score_alignment(e.alignment, e, gap_code)``: the
    edges' root alignments in one pass over one rooting of their graph."""
    if not edges:
        return []
    return _score([e.alignment for e in edges], edges[0], gap_code)


def score_alignment(alignment, root_edge, gap_code) -> int:
    """GapParsimony::scoreAlignment (GapParsimony.h:94-118): the gap
    parsimony of ``alignment`` on the graph of ``root_edge``."""
    return _score([alignment], root_edge, gap_code)[0]
