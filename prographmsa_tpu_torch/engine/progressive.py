"""Progressive alignment on the host.

Re-derivation of ProgressiveAlignment.{h,cpp}: post-order recursion over the
guide tree; leaves become sequence graphs; internal nodes clean, align,
merge, and extend the descendant alignments, each node refined after its
alignment under --early_refinement.  The port's copy of
prographmsa_tpu/engine/progressive.py with the host engines only.  This
recursion is the port's sequential oracle: the level scheduler
(engine/level_driver.py) and the root search (engine/find_root.py) run the
same alignments in batches on the device and are held against it.
"""

from __future__ import annotations

import operator
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
from ..errors import ParityError

from .. import timings
from ..graph.graph import Graph, sequence_graph, clean_graph, unclean_mapping
from ..align.scores import DynProgScores, precompute_scores
from ..align.dp import fill_dp
from ..align.backtrack import backtrack, AlignmentResult
from ..align.merge import merge_graphs, merge_graphs_incremental
from ..tree.phytree import PhyTree


@dataclass
class ProgressiveAlignmentResult:
    aligned_sequences: Dict[str, np.ndarray] = field(default_factory=dict)
    profiles: Dict[str, np.ndarray] = field(default_factory=dict)
    tr_homologies: List[np.ndarray] = field(default_factory=list)
    tr_source: List[str] = field(default_factory=list)
    graph: Graph = None
    score: float = 0.0
    n_tr_indels: int = 0
    is_csprofile: bool = False
    # the extended rows together (extend_children); see row_block
    block: Optional["RowBlock"] = None


def align_graphs(g1: Graph, g2: Graph, model, options,
                 scores=None) -> AlignmentResult:
    """alignGraphs (GraphAlign.h:201-534): scores -> S-matrix GEMM -> DP
    fill -> backtrack on the host.  ``options.engine`` is ``native`` (the
    C++ kernels, falling back stage by stage to numpy where the library is
    missing or declines a pair) or ``numpy`` (the reference path); both are
    bit-identical.  ``scores`` lets a caller (the level scheduler) reuse an
    already-computed DynProgScores instead of re-deriving it."""
    use_native = options.engine != "numpy"
    if scores is None:
        with timings.phase("scores"):
            scores = DynProgScores(g1, g2, model, options)
    if use_native:
        # fused native node alignment: S + fill + backtrack in ONE call
        # with thread-local scratch — the staged path below allocates five
        # numpy matrices and crosses ctypes ~60 times per node, which on
        # short guide-tree pairs costs more than the DP itself
        with timings.phase("dp_fused"):
            from .. import native
            aln = native.align_node_native(g1, g2, model, scores)
        if aln is not None:
            return aln, scores

    with timings.phase("scores"):
        S = precompute_scores(g1, g2, model, scores, options.engine)

    with timings.phase("dp_fill"):
        dp = None
        if use_native:
            from .. import native
            dp = native.fill_dp_native(g1, g2, S, scores)
        if dp is None:
            dp = fill_dp(g1, g2, S, scores)

    with timings.phase("backtrack"):
        aln = None
        if use_native:
            from .. import native
            aln = native.backtrack_native(g1, g2, dp, scores)
        if aln is None:
            aln = backtrack(g1, g2, dp, scores)
    return aln, scores


class RowBlock:
    """A result's extended rows in one array: ``cols[c, r]`` is column c of
    row ``names[r]``, so a child's column is one contiguous run of its
    rows and extending a child copies whole columns.  ``rows`` are the
    views of it that the result's ``aligned_sequences`` was given."""

    __slots__ = ("cols", "names", "rows")

    def __init__(self, cols, names):
        self.cols = cols
        self.names = names
        self.rows = list(cols.T)

    def row_index(self, names):
        """The rows of ``names``, in their order."""
        at = {nm: r for r, nm in enumerate(self.names)}
        return np.array([at[nm] for nm in names], dtype=np.intp)


def row_block(result):
    """``result``'s RowBlock while its ``aligned_sequences`` holds exactly
    the block's rows, in the block's order; else None (a leaf, or a dict
    that gained, lost or replaced a row since the block was made)."""
    b = getattr(result, "block", None)
    rows = result.aligned_sequences
    if (b is None or len(rows) != len(b.names)
            or not all(map(operator.is_, rows.values(), b.rows))
            or list(rows) != b.names):
        return None
    return b


def gap_flags(result, names, gap_code, out):
    """The gap flags of ``result``'s rows as a (columns, rows) bool view of
    the front of the uint8 buffer ``out``, and the rows of ``names`` in it,
    in that order: the result's block whole while it holds its rows, else
    the rows ``names`` read one by one.  ``out`` holds at least columns x
    max(len(result.aligned_sequences), len(names)) bytes."""
    b = row_block(result)
    if b is not None:
        cols, at = b.cols, b.row_index(names)
    else:
        rows = result.aligned_sequences
        cols = _read_rows({nm: rows[nm] for nm in names}, None)
        at = np.arange(len(names))
    flags = out[:cols.size].view(bool).reshape(cols.shape)
    np.equal(cols, gap_code, out=flags)
    return flags, at


def _hit(result, mapping):
    """The merged graph's columns that ``mapping`` maps (a boolean mask
    over the result's columns)."""
    n = result.graph.size
    return np.array(mapping[1:n - 1], dtype=np.intp) != -1


def _read_rows(rows, k):
    """The first ``k`` columns of the rows of the dict ``rows``, read one
    by one into an array laid out as a RowBlock's ``cols``."""
    if len(rows) == 1:
        return np.asarray(next(iter(rows.values())))[:k, None]
    return np.stack([r[:k] for r in rows.values()], axis=1)


def _extend_into(dest, hit, src, gap_code):
    """Gap-extend rows through the merged graph into ``dest`` (laid out as
    a RowBlock's ``cols``): ``src``'s first k columns (k = the mapped
    count; trailing originals beyond the last mapped column drop) to the
    mapped columns, gaps to the rest."""
    at = np.flatnonzero(hit)
    dest[at] = src[:len(at)]
    dest[np.flatnonzero(~hit)] = gap_code


def extend_children(result, children, gap_code):
    """Gap-extend each (mapping, child result) of ``children`` in turn
    through the merged graph (ProgressiveAlignment.h:245-287): the
    children's rows into one new RowBlock of ``result``, one copy of whole
    columns a child (from the child's own block where that still holds its
    rows), then their TR homologies."""
    with timings.phase("extend"):
        hits = [_hit(result, mapping) for mapping, _child in children]
        names = []
        for _mapping, child in children:
            names += child.aligned_sequences
        cols = np.empty((result.graph.size - 2, len(names)), dtype=np.int16)
        r0 = 0
        for hit, (_mapping, child) in zip(hits, children):
            rows = child.aligned_sequences
            if not rows:
                continue
            b = row_block(child)
            src = b.cols if b is not None else \
                _read_rows(rows, int(np.count_nonzero(hit)))
            _extend_into(cols[:, r0:r0 + len(rows)], hit, src, gap_code)
            r0 += len(rows)
        result.block = RowBlock(cols, names)
        result.aligned_sequences.update(zip(names, result.block.rows))
        for hit, (_mapping, child) in zip(hits, children):
            k = int(np.count_nonzero(hit))
            for original, source in zip(child.tr_homologies,
                                        child.tr_source):
                extended = np.full(len(hit), -1, dtype=np.int64)
                extended[hit] = original[:k]
                result.tr_homologies.append(extended)
                result.tr_source.append(source)


def create_ancestral_seq_name(aligned_sequences) -> str:
    """Sorted-leaf-list name "(A,B,...)" (ProgressiveAlignment.h:289-315)."""
    leaves = sorted(n for n in aligned_sequences if not n.startswith("("))
    return "(" + ",".join(leaves) + ")"


def _ancestral_from_cols(result, cols_ok, col_of, spec, model):
    """Shared max-posterior ancestral sequence + profile construction
    (ProgressiveAlignment.h:317-411)."""
    n = result.graph.size
    extended = np.full(n - 2, spec.gap_code, dtype=np.int16)
    profile_cols = []
    for i in range(1, n - 1):
        if cols_ok(i):
            col = col_of(i) * model.pi
            j = int(np.argmax(col))
            extended[i - 1] = spec.from_values(np.array([j]))[0]
            profile_cols.append(col / col.sum())
    return extended, (np.array(profile_cols) if profile_cols
                      else np.zeros((0, spec.DIM)))


def prelim_ancestral_seq(result, is_matched, model, spec):
    name = create_ancestral_seq_name(result.aligned_sequences)
    extended, profile = _ancestral_from_cols(
        result, lambda i: is_matched[i], lambda i: result.graph.sites[i].copy(),
        spec, model)
    result.aligned_sequences[name] = extended
    result.profiles[name] = profile


def final_ancestral_seq(result, mapping, matched, old_result, model, spec):
    name = create_ancestral_seq_name(old_result.aligned_sequences)
    extended, profile = _ancestral_from_cols(
        result, lambda i: matched[i] and mapping[i] != -1,
        lambda i: old_result.graph.sites[mapping[i]].copy(), spec, model)
    result.aligned_sequences[name] = extended
    result.profiles[name] = profile


def prealign_node(r1, r2, distance1, distance2, factory, options):
    """The model/cleaning stage of align_progressive_results, split out so
    the level-batched scheduler can prepare a whole level before one batched
    kernel launch (ProgressiveAlignment.h:418-437)."""
    gap_distance1 = distance1
    gap_distance2 = distance2
    if r1.is_csprofile:
        distance1 = 0.0
    if r2.is_csprofile:
        distance2 = 0.0
    gap_distance = gap_distance1 + gap_distance2
    distance = distance1 + distance2

    model = factory.get_model(distance, options, gap_distance)
    model1 = factory.get_model(distance1, options, gap_distance1)
    model2 = factory.get_model(distance2, options, gap_distance2)

    with timings.phase("clean"):
        cg1, outmap1 = clean_graph(r1.graph, options)
        cg2, outmap2 = clean_graph(r2.graph, options)
    return model, model1, model2, cg1, outmap1, cg2, outmap2


def merge_node(r1, r2, aln, prealigned, support1, support2, options):
    """The merge stage of align_progressive_results, split out so the
    level-batched scheduler can run independent nodes' merges on separate
    cores (pure function of the node's own inputs)."""
    model, model1, model2, cg1, outmap1, cg2, outmap2 = prealigned
    mapping1 = unclean_mapping(aln.mapping1, outmap1)
    mapping2 = unclean_mapping(aln.mapping2, outmap2)
    with timings.phase("merge"):
        return merge_graphs(r1.graph, r2.graph, mapping1, mapping2,
                            model1, model2, support1, support2, options)


def align_progressive_results(r1, r2, distance1, distance2, support1,
                              support2, factory, options, spec,
                              prealigned=None, aln=None, anc=None,
                              tr_print=True):
    """ProgressiveAlignment.h:413-476.  ``prealigned``/``aln``/``anc`` let
    the level-batched scheduler inject the already-computed stage results;
    ``tr_print=False`` defers the per-node TR stderr line to the caller
    (the level scheduler finishes nodes out of post-order and re-emits the
    lines in the reference's order afterwards)."""
    result = ProgressiveAlignmentResult()

    if prealigned is None:
        prealigned = prealign_node(r1, r2, distance1, distance2, factory,
                                   options)
    model, model1, model2, cg1, outmap1, cg2, outmap2 = prealigned

    if aln is None:
        aln, _scores = align_graphs(cg1, cg2, model, options)
    result.score = float(aln.score)
    result.is_csprofile = False
    result.n_tr_indels = aln.n_tr_indels + r1.n_tr_indels + r2.n_tr_indels
    result.profiles.update(r1.profiles)
    result.profiles.update(r2.profiles)

    if anc is None:
        anc = merge_node(r1, r2, aln, prealigned, support1, support2,
                         options)
    result.graph = anc.graph

    extend_children(result, ((anc.mapping1, r1), (anc.mapping2, r2)),
                    spec.gap_code)

    if options.ancestral_flag:
        if len(r1.aligned_sequences) > 1:
            final_ancestral_seq(result, anc.mapping1, anc.is_matched, r1,
                                model1, spec)
        if len(r2.aligned_sequences) > 1:
            final_ancestral_seq(result, anc.mapping2, anc.is_matched, r2,
                                model2, spec)
        prelim_ancestral_seq(result, anc.is_matched, model, spec)

    result.graph.add_repeats(result.tr_homologies)

    if options.repeats_flag and tr_print:
        # ProgressiveAlignment.h:470-473: per-node TR-indel count of THIS
        # alignment (not the accumulated subtree total) to stderr.
        import sys
        print("TR indels at %s: %d"
              % (create_ancestral_seq_name(result.aligned_sequences),
                 aln.n_tr_indels), file=sys.stderr)
    return result


def progressive_alignment(spec, sequences, tree: PhyTree, repeats, csprofile,
                          factory, options,
                          alignment_cache: Optional[dict] = None
                          ) -> ProgressiveAlignmentResult:
    """ProgressiveAlignment.h:59-113.  ``alignment_cache`` receives every
    node's (refined) result by ``id`` of its tree node, which the early
    refinement of its grandparent reads."""
    result = ProgressiveAlignmentResult()
    result.is_csprofile = False

    if tree.is_leaf():
        name = tree.name
        if name not in sequences:
            raise ParityError("unknown sequence name: %s" % name)
        seq = sequences[name]
        if csprofile is not None and spec.name == "aa":
            from ..cs_profile import cs_sequence_graph
            model = factory.get_model(tree.branch_length, options)
            result.graph = cs_sequence_graph(spec, seq, csprofile, model)
            result.is_csprofile = True
        else:
            result.graph = sequence_graph(spec, seq)
        result.aligned_sequences[name] = seq
        result.profiles[name] = result.graph.sites[1:-1].copy()
        result.score = 0.0
        result.n_tr_indels = 0

        if name in repeats:
            for rep in repeats[name]:
                tr_hom = np.full(result.graph.size, -1, dtype=np.int64)
                tr_hom[rep.start + 1:rep.start + 1 + len(rep.tr_hom)] = \
                    rep.tr_hom
                result.tr_homologies.append(tr_hom)
                result.tr_source.append(name)
            result.graph.add_repeats(result.tr_homologies)
    else:
        if tree.n_children() != 2:
            raise ParityError("only bifurcating trees allowed")
        r1 = progressive_alignment(spec, sequences, tree[0], repeats,
                                   csprofile, factory, options,
                                   alignment_cache)
        r2 = progressive_alignment(spec, sequences, tree[1], repeats,
                                   csprofile, factory, options,
                                   alignment_cache)
        result = align_progressive_results(
            r1, r2, tree[0].branch_length, tree[1].branch_length,
            tree[0].branch_support, tree[1].branch_support, factory, options,
            spec)
        if options.earlyref_flag:
            from .early_refinement import early_refinement
            result = early_refinement(result, tree, factory, options, spec,
                                      alignment_cache)

    if options.earlyref_flag and alignment_cache is not None:
        alignment_cache[id(tree)] = result

    return result
