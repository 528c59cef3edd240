"""Guide-tree construction wrapper (reference: TreeNJ.h:28-59).

Distance factory dispatch (DistanceFactory.cpp:8-55): prealigned ->
column-count ML distances; --nwdist -> NW alignment distances; default ->
angle (k-mer) distances.  Then BioNJ, optional WLS refinement, midpoint root.
All three distance stages run on the host here; their device programs are
still to be ported (ROADMAP.md).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from .. import timings
from .nj import build_nj_tree
from .phytree import PhyTree, midpoint_root
from ..distances.angle import compute_angle_distances
from ..distances.prealigned import compute_prealigned_distances


def compute_distances(spec, seqs: Dict[str, np.ndarray], order: List[str],
                      factory, options, prealigned: bool):
    if prealigned:
        return compute_prealigned_distances(spec, seqs, order, factory, options)
    if options.nwdist_flag:
        from ..distances.align import compute_nw_distances
        return compute_nw_distances(spec, seqs, order, factory, options)
    return compute_angle_distances(spec, seqs, order, options)


def tree_nj(spec, seqs: Dict[str, np.ndarray], prealigned: bool, factory,
            options, topo: Optional[PhyTree] = None) -> PhyTree:
    if len(seqs) < 2:
        raise ValueError("cannot construct tree from < 2 sequences")

    order = sorted(seqs.keys())  # std::map iteration order
    with timings.phase("distances"):
        distances, variances = compute_distances(spec, seqs, order, factory,
                                                 options, prealigned)
        distances = np.array(distances)
        variances = np.array(variances)
        np.fill_diagonal(distances, 0.0)
        np.fill_diagonal(variances, 0.0)

    with timings.phase("nj"):
        tree = build_nj_tree(order, distances, variances, options, topo)

    if options.wlsrefine_flag:
        from .least_squares import refine_tree
        with timings.phase("wls"):
            tree = refine_tree(tree, order, distances, variances, options)

    return midpoint_root(tree)
