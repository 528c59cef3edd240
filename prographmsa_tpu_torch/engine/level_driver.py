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

The host stage of a batch runs in the native library's batches
(native.batches): every graph's cleaning, every host alignment, every
merge and every row block of the batch in one call each, spread over
``PROGRAPHMSA_THREADS`` threads (default: the cores) with the GIL
released; Python then builds each node's objects on this thread.  Under
--timings ``clean``, ``dp_fused``, ``merge`` and ``extend`` time those
calls once a batch: wall time on this thread.  The nodes' result objects
are built after the batches, in no phase.  The pairs the library declines
(a repeat slot) take the staged path over ``HostPool``'s threads, whose
``scores``, ``dp_fill`` and ``backtrack`` phases sum over the threads.
Without the library (``PROGRAPHMSA_NATIVE=0``, no compiler) each node
runs its Python path, the host alignments and merges over ``HostPool``'s
threads.
"""

from __future__ import annotations

import sys
from concurrent.futures import ThreadPoolExecutor

from .. import native, timings
from ..align.backtrack import AlignmentResult
from ..align.merge import merge_graphs_batch
from ..align.scores import DynProgScores
from ..engine_policy import use_torch_dp
from ..errors import ParityError
from .early_refinement import refine, refinement_inputs
from ..graph.graph import clean_graphs
from .progressive import (
    align_graphs, align_progressive_results, create_ancestral_seq_name,
    extend_blocks, node_models, prealign_node, progressive_alignment,
    staged_align)


class HostPool:
    """Threads for the host work that the native batches do not take: every
    node's host alignment and merge on the path without the library, and
    the staged alignments of the pairs the library declines."""

    def __init__(self):
        self.nt = native.n_threads()
        self.pool = (ThreadPoolExecutor(max_workers=self.nt)
                     if self.nt > 1 else None)
        if native.lib() is not None:   # build/load once, on this thread
            native._blas_ptrs()

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
    there (engine_policy.use_torch_dp), the host for the rest and for
    every pair the batch hands back: one native batch (native.align_batch,
    ``--timings`` phase ``dp_fused``), then ``staged_align`` for each pair
    it declines, over ``pool``; without the batches ``align_graphs`` over
    ``pool``.  Called from the scheduler's main thread only, never from
    ``pool``: over processes the batch issues collectives, which every
    process must reach in one order."""
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
    if host and native.batches(options):
        with timings.phase("dp_fused"):
            got = native.align_batch([items[k] for k in host])
        for k, a in zip(host, got):
            alns[k] = a
        # the pairs the library declines (a repeat slot), their staged way
        # over ``pool``: its fill and backtrack release the GIL
        declined = [k for k in host if alns[k] is None]

        def staged(js):
            for j in js:
                g1, g2, model, scores = items[declined[j]]
                alns[declined[j]] = staged_align(g1, g2, model, options,
                                                 scores)

        pool.run(len(declined), staged)
        return alns

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
    host, the pairs through ``align_items``, the merges in native batches
    (``_align_tasks_native``), or without them over ``pool``.
    Returns (result, n_tr_indels of the node's own alignment) per task; the
    caller prints the TR lines in its order."""
    if native.batches(options):
        return _align_tasks_native(tasks, factory, options, spec, device,
                                   engine, pool, mesh)
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


def _align_tasks_native(tasks, factory, options, spec, device, engine,
                        pool, mesh):
    """``align_tasks`` with the host stage in native batches: the
    cleanings, the merges and the row blocks each one call over the
    tasks, the host alignments one in ``align_items``; then each node's
    result object built here, in the tasks' order."""
    models = [node_models(r1, r2, d1, d2, factory, options)
              for r1, r2, d1, d2, _s1, _s2 in tasks]
    with timings.phase("clean"):
        cleaned = clean_graphs([r.graph for t in tasks for r in t[:2]],
                               options)
    preps, items = [], []
    for k, (model, model1, model2) in enumerate(models):
        (cg1, om1), (cg2, om2) = cleaned[2 * k], cleaned[2 * k + 1]
        preps.append((model, model1, model2, cg1, om1, cg2, om2))
        items.append((cg1, cg2, model, DynProgScores(cg1, cg2, model,
                                                     options)))
    alns = align_items(items, options, device, engine, pool, mesh)
    with timings.phase("merge"):
        ancs = merge_graphs_batch(
            [(r1.graph, r2.graph, aln.mapping1, aln.mapping2, p[4], p[6],
              p[1], p[2], s1, s2)
             for (r1, r2, _d1, _d2, s1, s2), aln, p
             in zip(tasks, alns, preps)], options)
    with timings.phase("extend"):
        blocks = extend_blocks(
            [(anc.graph.size, ((anc.mapping1, t[0]), (anc.mapping2, t[1])))
             for t, anc in zip(tasks, ancs)], spec.gap_code)
    return [(align_progressive_results(
        r1, r2, d1, d2, s1, s2, factory, options, spec, prealigned=p,
        aln=aln, anc=anc, tr_print=False, block=block), aln.n_tr_indels)
        for (r1, r2, d1, d2, s1, s2), p, aln, anc, block
        in zip(tasks, preps, alns, ancs, blocks)]


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
    in one ``align_items`` batch, then each node's incremental merges on
    this thread (mostly Python: over threads they wait for the GIL); the
    refined result replaces the node's, where its parent and grandparent
    read it."""
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

    for i, old_results, models, at in jobs:
        results[i] = refine(results[i], old_results, models,
                            alns[at:at + len(old_results)], spec)
