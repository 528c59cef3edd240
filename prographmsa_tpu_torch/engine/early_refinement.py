"""Early refinement (--early_refinement).

Behavioral port of earlyRefinement (ProgressiveAlignment.h:115-243), the
port's copy of prographmsa_tpu/engine/early_refinement.py: after aligning a
node, re-align its up-to-4 grandchild subalignments incrementally against
the (reset) ancestor graph, then drop unused nodes.

Every re-alignment aligns against the node's fixed merged graph, so the
alignments of one node are independent of each other and of the merges;
only the incremental merges thread the ancestor graph.  The function is
split on that line: ``refinement_inputs`` names the pairs, ``refine`` merges
their alignments.  ``early_refinement`` runs both with the host
``align_graphs`` (the sequential recursion); the level scheduler
(engine/level_driver.py) sends the pairs of a whole level through its batch
in between.
"""

from __future__ import annotations

from typing import List

from ..align.merge import merge_graphs_incremental
from .progressive import (ProgressiveAlignmentResult, align_graphs,
                          extend_children)


def refinement_inputs(old_result, tree, factory, options, result_of):
    """The subalignments that ``old_result`` (the node ``tree``'s alignment)
    re-aligns, and a model for each; None when both children are leaves.
    ``result_of(t)`` is the (refined) result of the tree node ``t``."""
    if tree[0].is_leaf() and tree[1].is_leaf():
        return None

    old_results = []
    distances = []
    gap_distances = []
    for i in range(tree.n_children()):
        child = tree[i]
        if child.is_leaf():
            r = result_of(child)
            old_results.append(r)
            gap_distances.append(child.branch_length)
            distances.append(0.0 if r.is_csprofile else child.branch_length)
        else:
            parent = child
            assert parent.n_children() == 2
            for j in range(tree.n_children()):
                r = result_of(parent[j])
                old_results.append(r)
                gap_distances.append(parent.branch_length
                                     + parent[j].branch_length)
                d = parent.branch_length
                if not r.is_csprofile:
                    d += parent[j].branch_length
                distances.append(d)
    assert len(old_results) >= 2
    models = [factory.get_model(d, options, gd)
              for d, gd in zip(distances, gap_distances)]
    return old_results, models


def refine(old_result, old_results, models, alns, spec):
    """The refined result from the alignments ``alns`` of
    ``old_result.graph`` with each of ``old_results``' graphs."""
    n_results = len(old_results)
    result = ProgressiveAlignmentResult()
    result.score = old_result.score
    result.is_csprofile = False
    result.n_tr_indels = old_result.n_tr_indels

    mappings: List[List[int]] = [None] * n_results
    anc_graph = old_result.graph.copy()
    anc_graph.reset_sites()
    anc_mapping = list(range(anc_graph.size))

    for i in range(n_results):
        aln = alns[i]
        mapping1 = [anc_mapping[m] if m != -1 else -1 for m in aln.mapping1]

        anc = merge_graphs_incremental(anc_graph, old_results[i].graph,
                                       mapping1, aln.mapping2, models[i])
        anc_graph = anc.graph
        mappings[i] = anc.mapping2

        inv_mapping = [-2] * anc_graph.size
        for j, m in enumerate(anc.mapping1):
            if m != -1:
                inv_mapping[m] = j
        anc_mapping = [inv_mapping[m] for m in anc_mapping]

        for j in range(i):
            new_mapping = []
            for k in range(anc_graph.size):
                mk = anc.mapping1[k]
                if mk != -1:
                    mk = mappings[j][mk]
                new_mapping.append(mk)
            mappings[j] = new_mapping

    # remove unused nodes (ProgressiveAlignment.h:201-230)
    i = 0
    while i < anc_graph.size:
        if any(mappings[j][i] != -1 for j in range(n_results)):
            i += 1
            continue
        j2 = i + 1
        removed = False
        while j2 < anc_graph.size:
            if any(mappings[k][j2] != -1 for k in range(n_results)):
                anc_graph.rm_nodes(i, j2 - i)
                for k in range(n_results):
                    del mappings[k][i:j2]
                removed = True
                break
            j2 += 1
        if not removed:
            i += 1

    result.graph = anc_graph
    extend_children(result, list(zip(mappings, old_results)), spec.gap_code)
    result.graph.add_repeats(result.tr_homologies)
    return result


def early_refinement(old_result, tree, factory, options, spec,
                     alignment_cache):
    """earlyRefinement with the host ``align_graphs``; ``alignment_cache``
    maps ``id`` of a tree node to its result."""
    inputs = refinement_inputs(old_result, tree, factory, options,
                               lambda t: alignment_cache[id(t)])
    if inputs is None:
        return old_result
    old_results, models = inputs
    alns = [align_graphs(old_result.graph, r.graph, m, options)[0]
            for r, m in zip(old_results, models)]
    return refine(old_result, old_results, models, alns, spec)
