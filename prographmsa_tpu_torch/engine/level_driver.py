"""Level-synchronous progressive alignment over the port's device DP.

The port of prographmsa_tpu/engine/level_driver.py: per guide-tree level it
prepares every ready node on the host (models, graph cleaning), aligns the
level's pairs in one device batch (align/graph_dp_cuda.py) when ``device``
is given and the port's ``engine`` sends the level there (``auto``: when
the level's cells reach the calibrated threshold,
engine_policy.use_torch_dp), and merges each node on the host.  Pairs the
batch hands back (``None``) and every pair of a level kept on the host are
aligned by the host ``align_graphs`` (engine/progressive.py); under
``--timings`` each pair the batch hands back shows as a ``torch_fb_*``
counter, and ``torch_levels_device`` / ``torch_levels_host`` count the
levels each side took (the batch's own ``dp_prep``, ``dp_device`` and
``dp_harvest`` phases time it).  ``options`` is the host options object
and carries ``engine="native"`` for the host layers.
"""

from __future__ import annotations

import sys
from concurrent.futures import ThreadPoolExecutor

from .. import native, timings
from ..align import graph_dp_cuda
from ..align.backtrack import AlignmentResult
from ..align.scores import DynProgScores
from ..engine_policy import use_torch_dp
from ..errors import ParityError
from .progressive import (
    align_graphs, align_progressive_results, create_ancestral_seq_name,
    prealign_node, progressive_alignment)


def _collect_nodes(tree):
    """Post-order node list with child indices."""
    nodes = []

    def rec(t):
        if t.is_leaf():
            nodes.append((t, None, None))
            return len(nodes) - 1
        if t.n_children() != 2:
            raise ParityError("only bifurcating trees allowed")
        c0 = rec(t[0])
        c1 = rec(t[1])
        nodes.append((t, c0, c1))
        return len(nodes) - 1

    rec(tree)
    return nodes


def progressive_alignment_batched(spec, sequences, tree, repeats, csprofile,
                                  factory, options, device=None,
                                  engine: str = "torch"):
    """Level-batched progressive alignment; ``device`` (a torch.device)
    runs the DP batch of each level that ``engine`` sends there, None keeps
    every pair on the host."""
    nodes = _collect_nodes(tree)
    results = [None] * len(nodes)
    nt = native.n_threads()
    pool = ThreadPoolExecutor(max_workers=nt) if nt > 1 else None
    if pool is not None:
        native.lib()  # build/load once before the pool races on it
    try:
        for i, (t, c0, _c1) in enumerate(nodes):
            if c0 is None:
                results[i] = progressive_alignment(
                    spec, sequences, t, repeats, csprofile, factory, options)
        pending = [i for i, (_t, c0, _c1) in enumerate(nodes)
                   if c0 is not None]
        tr_counts = {}
        while pending:
            ready = [i for i in pending
                     if results[nodes[i][1]] is not None
                     and results[nodes[i][2]] is not None]
            if not ready:
                raise ParityError("tree level scheduling stuck")
            _align_level(ready, nodes, results, tr_counts, spec, factory,
                         options, device, engine, pool, nt)
            done = set(ready)
            pending = [i for i in pending if i not in done]
    finally:
        if pool is not None:
            pool.shutdown(wait=True)

    if options.repeats_flag:
        # the reference's per-node TR lines, in its post-order
        for i, (_t, c0, _c1) in enumerate(nodes):
            if c0 is not None:
                print("TR indels at %s: %d"
                      % (create_ancestral_seq_name(
                          results[i].aligned_sequences), tr_counts[i]),
                      file=sys.stderr)
    return results[-1]


def _align_level(ready, nodes, results, tr_counts, spec, factory, options,
                 device, engine, pool, nt):
    preps, items = {}, []
    for i in ready:
        t, c0, c1 = nodes[i]
        pre = prealign_node(results[c0], results[c1], t[0].branch_length,
                            t[1].branch_length, factory, options)
        preps[i] = pre
        model, _m1, _m2, cg1, _o1, cg2, _o2 = pre
        items.append((cg1, cg2, model, DynProgScores(cg1, cg2, model,
                                                     options)))

    batch = [None] * len(items)
    level_cells = sum(it[0].size * it[1].size for it in items)
    on_card = device is not None and use_torch_dp(engine, level_cells)
    if device is not None:
        timings.count("torch_levels_device" if on_card
                      else "torch_levels_host")
    if on_card:
        before = graph_dp_cuda.fallback_stats()
        batch = graph_dp_cuda.align_pairs_device(items, device)
        after = graph_dp_cuda.fallback_stats()
        for k, v in after.items():
            if v > before[k]:
                timings.count("torch_" + k, v - before[k])
    alns = [None if r is None else
            AlignmentResult(score=r[2], n_tr_indels=r[3], mapping1=r[0],
                            mapping2=r[1]) for r in batch]

    def finish(ks):
        for k in ks:
            i = ready[k]
            aln = alns[k]
            if aln is None:
                cg1, cg2, model, scores = items[k]
                aln = align_graphs(cg1, cg2, model, options,
                                   scores=scores)[0]
            t, c0, c1 = nodes[i]
            tr_counts[i] = aln.n_tr_indels
            results[i] = align_progressive_results(
                results[c0], results[c1], t[0].branch_length,
                t[1].branch_length, t[0].branch_support,
                t[1].branch_support, factory, options, spec,
                prealigned=preps[i], aln=aln, tr_print=False)

    # host align fallbacks and merges are pure functions of each node's own
    # inputs: one task per worker over the level (native code drops the GIL)
    if pool is not None and len(ready) > 1:
        shards = [list(range(len(ready)))[s::nt] for s in range(nt)]
        for fut in [pool.submit(finish, sh) for sh in shards]:
            fut.result()
    else:
        finish(range(len(ready)))
