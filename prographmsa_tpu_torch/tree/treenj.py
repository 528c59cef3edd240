"""Guide-tree construction wrapper (reference: TreeNJ.h:28-59).

Distance factory dispatch (DistanceFactory.cpp:8-55): prealigned ->
column-count ML distances; --nwdist -> NW alignment distances; default ->
angle (k-mer) distances.  Then BioNJ, optional WLS refinement, midpoint root.
Which stage runs on the card is the port's engine policy
(engine_policy.py): the caller passes the run's ``device`` and ``engine``
explicitly; the host ``options`` carry ``engine="native"`` and are not
read for it.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from .. import timings
from .nj import build_nj_tree
from .phytree import PhyTree, midpoint_root
from ..distances.angle import (compute_angle_distances,
                               compute_angle_distances_device)
from ..distances.prealigned import compute_prealigned_distances
from ..engine_policy import use_device_angle


def compute_distances(spec, seqs: Dict[str, np.ndarray], order: List[str],
                      factory, options, prealigned: bool, device=None,
                      engine: str = "native", mesh=None):
    if prealigned:
        return compute_prealigned_distances(spec, seqs, order, factory,
                                            options, device, engine)
    if options.nwdist_flag:
        from ..distances.align import compute_nw_distances
        return compute_nw_distances(spec, seqs, order, factory, options,
                                    device, engine, mesh=mesh)
    if use_device_angle(engine):
        return compute_angle_distances_device(spec, seqs, order, options,
                                              device)
    return compute_angle_distances(spec, seqs, order, options)


def tree_nj(spec, seqs: Dict[str, np.ndarray], prealigned: bool, factory,
            options, topo: Optional[PhyTree] = None, device=None,
            engine: str = "native", mesh=None) -> PhyTree:
    if len(seqs) < 2:
        raise ValueError("cannot construct tree from < 2 sequences")

    order = sorted(seqs.keys())  # std::map iteration order
    with timings.phase("distances"):
        distances, variances = compute_distances(spec, seqs, order, factory,
                                                 options, prealigned, device,
                                                 engine, mesh)
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
