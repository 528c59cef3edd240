"""Gap-parsimony scoring of an alignment rooted at an unrooted-graph edge.

Re-derivation of GapParsimony.h: per column a 2-state
(character/gap) Fitch parsimony over the unrooted tree.  The reference packs
2 bits per column into unsigned longs and counts conflicts with popcount
(GapParsimony.h:36-92); here each consensus is two boolean numpy arrays
(char-bit, gap-bit) — identical conflict counts, vectorized over columns.
"""

from __future__ import annotations

import numpy as np


def _leaf_consensus(aligned_sequences, name, gap_code):
    seq = np.asarray(aligned_sequences[name], dtype=np.int64)
    is_gap = seq == gap_code
    # bit (pos*2 + isGap): low bit = character, high bit = gap
    return ~is_gap, is_gap


def _score_subtree(alignment, node, other_edge, gap_code):
    """GapParsimony::scoreSubtree (GapParsimony.h:36-92).
    Returns ((char_bits, gap_bits), score)."""
    if node.is_leaf():
        return _leaf_consensus(alignment.aligned_sequences, node.name,
                               gap_code), 0

    edge1 = node.edges[1] if node.edges[0] is other_edge else node.edges[0]
    edge2 = node.edges[1] if node.edges[2] is other_edge else node.edges[2]
    node1 = edge1.nodes[1] if edge1.nodes[0] is node else edge1.nodes[0]
    node2 = edge2.nodes[1] if edge2.nodes[0] is node else edge2.nodes[0]

    (c1, g1), s1 = _score_subtree(alignment, node1, edge1, gap_code)
    (c2, g2), s2 = _score_subtree(alignment, node2, edge2, gap_code)

    c = c1 & c2
    g = g1 & g2
    conflict = ~(c | g)
    score = s1 + s2 + int(conflict.sum())
    return (c | conflict, g | conflict), score


def score_alignment(alignment, root_edge, gap_code) -> int:
    """GapParsimony::scoreAlignment (GapParsimony.h:94-118)."""
    (c1, g1), s1 = _score_subtree(alignment, root_edge.nodes[0], root_edge,
                                  gap_code)
    (c2, g2), s2 = _score_subtree(alignment, root_edge.nodes[1], root_edge,
                                  gap_code)
    conflict = ~((c1 & c2) | (g1 & g2))
    return s1 + s2 + int(conflict.sum())
