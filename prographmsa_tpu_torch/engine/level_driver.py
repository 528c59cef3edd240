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
batches each side took: levels, refinement batches and the root search's
waves (the batch's own ``dp_prep``, ``dp_device`` and
``dp_harvest`` phases time it).  ``options`` is the host options object
and carries ``engine="native"`` for the host layers.

Two functions carry the batch and are shared with the root search
(engine/find_root.py): ``align_items`` aligns a list of graph pairs, on the
card when the engine sends them there, and ``align_tasks`` aligns and merges
independent nodes.  Under --early_refinement each level's refinement pairs
(engine/early_refinement.py) go through ``align_items`` as one more batch
after the level's merges.
"""

from __future__ import annotations

import sys
from concurrent.futures import ThreadPoolExecutor

from .. import native, timings
from ..align.backtrack import AlignmentResult
from ..align.scores import DynProgScores
from ..engine_policy import use_torch_dp
from ..errors import ParityError
from .early_refinement import refine, refinement_inputs
from .progressive import (
    align_graphs, align_progressive_results, create_ancestral_seq_name,
    prealign_node, progressive_alignment)


class HostPool:
    """The native tier's threads: independent host work (alignments the
    batch hands back or that stay on the host, merges) spread over them;
    the native code drops the GIL."""

    def __init__(self):
        self.nt = native.n_threads()
        self.pool = (ThreadPoolExecutor(max_workers=self.nt)
                     if self.nt > 1 else None)
        if self.pool is not None:
            native.lib()  # build/load once before the pool races on it

    def run(self, n, fn):
        """``fn(ks)`` over shards of range(n), one per thread."""
        if self.pool is None or n < 2:
            fn(range(n))
            return
        shards = [range(s, n, self.nt) for s in range(self.nt)]
        for fut in [self.pool.submit(fn, sh) for sh in shards]:
            fut.result()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if self.pool is not None:
            self.pool.shutdown(wait=True)


def align_items(items, options, device, engine, pool, mesh=None):
    """One ``AlignmentResult`` per (g1, g2, model, scores) item: the batch
    on ``device``, or split over the shards of ``mesh``
    (engine_policy.level_mesh), when ``engine`` sends the items' cells
    there (engine_policy.use_torch_dp), the host ``align_graphs`` for the
    rest and for every pair the batch hands back.  Called from the
    scheduler's main thread only, never from ``pool``: over processes the
    batch issues collectives, which every process must reach in one
    order."""
    if not items:
        return []
    batch = [None] * len(items)
    cells = sum(it[0].size * it[1].size for it in items)
    on_card = device is not None and use_torch_dp(engine, cells)
    if device is not None:
        timings.count("torch_levels_device" if on_card
                      else "torch_levels_host")
    if on_card:
        from ..align import graph_dp_cuda   # imports torch; native does not

        before = graph_dp_cuda.fallback_stats()
        batch = graph_dp_cuda.align_pairs_device(items, device, mesh)
        after = graph_dp_cuda.fallback_stats()
        for k, v in after.items():
            if v > before[k]:
                timings.count("torch_" + k, v - before[k])
    alns = [None if r is None else
            AlignmentResult(score=r[2], n_tr_indels=r[3], mapping1=r[0],
                            mapping2=r[1]) for r in batch]
    host = [k for k, a in enumerate(alns) if a is None]

    def on_host(ks):
        for k in ks:
            g1, g2, model, scores = items[host[k]]
            alns[host[k]] = align_graphs(g1, g2, model, options,
                                         scores=scores)[0]

    pool.run(len(host), on_host)
    return alns


def align_tasks(tasks, factory, options, spec, device, engine, pool,
                mesh=None):
    """Align and merge independent nodes, each task
    (r1, r2, distance1, distance2, support1, support2) as
    ``align_progressive_results`` takes them: models and cleaning on the
    host, the pairs through ``align_items``, the merges over ``pool``.
    Returns (result, n_tr_indels of the node's own alignment) per task; the
    caller prints the TR lines in its order."""
    preps, items = [], []
    for r1, r2, d1, d2, _s1, _s2 in tasks:
        pre = prealign_node(r1, r2, d1, d2, factory, options)
        preps.append(pre)
        model, _m1, _m2, cg1, _o1, cg2, _o2 = pre
        items.append((cg1, cg2, model, DynProgScores(cg1, cg2, model,
                                                     options)))
    alns = align_items(items, options, device, engine, pool, mesh)
    out = [None] * len(tasks)

    def merge(ks):
        for k in ks:
            r1, r2, d1, d2, s1, s2 = tasks[k]
            out[k] = (align_progressive_results(
                r1, r2, d1, d2, s1, s2, factory, options, spec,
                prealigned=preps[k], aln=alns[k], tr_print=False),
                alns[k].n_tr_indels)

    pool.run(len(tasks), merge)
    return out


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
                                  engine: str = "torch", mesh=None):
    """Level-batched progressive alignment; ``device`` (a torch.device)
    runs the DP batch of each level that ``engine`` sends there, split over
    ``mesh`` where one is given; None keeps every pair on the host.  Equal
    to the sequential ``progressive_alignment``, refinement included."""
    nodes = _collect_nodes(tree)
    index = {id(t): i for i, (t, _c0, _c1) in enumerate(nodes)}
    results = [None] * len(nodes)
    tr_counts = {}
    with HostPool() as pool:
        for i, (t, c0, _c1) in enumerate(nodes):
            if c0 is None:
                results[i] = progressive_alignment(
                    spec, sequences, t, repeats, csprofile, factory, options)
        pending = [i for i, (_t, c0, _c1) in enumerate(nodes)
                   if c0 is not None]
        while pending:
            ready = [i for i in pending
                     if results[nodes[i][1]] is not None
                     and results[nodes[i][2]] is not None]
            if not ready:
                raise ParityError("tree level scheduling stuck")
            tasks = []
            for i in ready:
                t, c0, c1 = nodes[i]
                tasks.append((results[c0], results[c1], t[0].branch_length,
                              t[1].branch_length, t[0].branch_support,
                              t[1].branch_support))
            aligned = align_tasks(tasks, factory, options, spec, device,
                                  engine, pool, mesh)
            for i, (res, ntr) in zip(ready, aligned):
                results[i] = res
                tr_counts[i] = ntr
            if options.earlyref_flag:
                _refine_level(ready, nodes, results, index, factory, options,
                              spec, device, engine, pool, mesh)
            done = set(ready)
            pending = [i for i in pending if i not in done]

    if options.repeats_flag:
        # the reference's per-node TR lines, in its post-order
        for i, (_t, c0, _c1) in enumerate(nodes):
            if c0 is not None:
                print("TR indels at %s: %d"
                      % (create_ancestral_seq_name(
                          results[i].aligned_sequences), tr_counts[i]),
                      file=sys.stderr)
    return results[-1]


def _refine_level(ready, nodes, results, index, factory, options, spec,
                  device, engine, pool, mesh=None):
    """The early refinement of every node of a level: all its re-alignments
    in one ``align_items`` batch, then each node's incremental merges over
    ``pool``; the refined result replaces the node's, where its parent and
    grandparent read it."""
    jobs, items = [], []
    for i in ready:
        inputs = refinement_inputs(results[i], nodes[i][0], factory, options,
                                   lambda t: results[index[id(t)]])
        if inputs is None:
            continue
        old_results, models = inputs
        jobs.append((i, old_results, models, len(items)))
        g1 = results[i].graph
        items += [(g1, r.graph, m, DynProgScores(g1, r.graph, m, options))
                  for r, m in zip(old_results, models)]
    alns = align_items(items, options, device, engine, pool, mesh)

    def merge(ks):
        for k in ks:
            i, old_results, models, at = jobs[k]
            results[i] = refine(results[i], old_results, models,
                                alns[at:at + len(old_results)], spec)

    pool.run(len(jobs), merge)
