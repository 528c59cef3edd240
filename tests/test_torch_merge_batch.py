"""The level's host stage in native batches (prographmsa_tpu_torch/native/
graphcore.cpp ``gc_clean_batch_*``, ``gc_align_batch_*``,
``gc_merge_batch_*``, ``gc_extend_batch``; engine/level_driver.py
``_align_tasks_native``) against the per-node path and the JAX package.

Each level of a run is held three ways: the batch's node results against
the per-node path (the native wrappers node by node over the host pool,
as before the batches) and, on fam20, against the Python bodies alone
(the library off, as ``PROGRAPHMSA_NATIVE=0`` leaves it); the batch's
cleanings, merges and row blocks array by array against ``clean_graph``,
the port's and the JAX package's ``merge_graphs`` and the JAX package's
``extend_alignment``, floats bit for bit.  Inputs: fam20's levels, rep8
with its repeats (repeat edges, TR homologies), DNA, codons, fam6 with
``--ancestral_seqs`` (dicts that left their blocks) and seeded random
trees (supports and the alternative-splicing probability chosen so that
edges of infinite cost make the cleaning drop nodes).  Then 1, 2, 3 and 8
threads give identical results, a library that fails inside a batch
fails the run (never retried node by node), and the native tier's CLI
reproduces the goldens at one thread and eight.  The same goldens on
``--device cpu`` are in test_torch_merge_batch_cli.py.
"""

import ctypes
import os

import numpy as np
import pytest

from prographmsa_tpu.align import merge as ref_merge
from prographmsa_tpu.engine import progressive as ref_prog

from prographmsa_tpu_torch import native
from prographmsa_tpu_torch.align import merge as mg
from prographmsa_tpu_torch.engine import level_driver as ld
from prographmsa_tpu_torch.engine import progressive as prog
from prographmsa_tpu_torch.graph import graph as gr
from prographmsa_tpu_torch.tree.phytree import PhyTree

from test_e2e_differential import FIX, G, run_cli
from test_torch_cli import _check
from test_torch_find_root import recording, same_result, setup, stderr_of

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="the native library did not build")


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view({8: np.uint64, 4: np.uint32}[a.dtype.itemsize]) \
        if a.dtype.kind == "f" else a


def _same_arrays(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, what
    assert np.array_equal(_bits(a), _bits(b)), what


def _same_padded(ga, gb, what):
    _same_arrays(ga.sites, gb.sites, what + " sites")
    for x, y, nm in zip(ga.padded(), gb.padded(),
                        ("idx", "cost", "isrep", "units")):
        _same_arrays(x, y, "%s %s" % (what, nm))


def _balanced(names, rng=None):
    """A bifurcating tree over ``names``: balanced with fixed branch
    lengths, or, with ``rng``, joined at random with random lengths and
    supports (0, 1 and between)."""
    nodes = [PhyTree(nm) for nm in names]
    while len(nodes) > 1:
        if rng is None:
            a, b = nodes.pop(0), nodes.pop(0)
        else:
            i, j = sorted(rng.choice(len(nodes), 2, replace=False))
            b, a = nodes.pop(j), nodes.pop(i)
        t = PhyTree()
        for c in (a, b):
            if rng is None:
                t.add_child(c, 0.1 + 0.01 * len(nodes))
            else:
                s = float(rng.choice([0.0, 1.0, 1.0, 1.0, rng.random()]))
                t.add_child(c, float(rng.uniform(0.01, 1.2)), s)
        nodes.append(t)
    return nodes[0]


def _input(name, **flags):
    """(spec, sequences, tree, repeats, factory, options) of a named
    input: fam6, fam20 and rep8 with their golden trees, DNA (dna12 with
    dna.qmat) and codons (orf10) on a balanced tree."""
    if name in ("fam6", "fam20", "rep8"):
        return setup("prographmsa_tpu_torch", name, **flags)
    from prographmsa_tpu_torch.alphabet import get_alphabet
    from prographmsa_tpu_torch.config import Options
    from prographmsa_tpu_torch.io.fasta import read_fasta
    from prographmsa_tpu_torch.models.factory import \
        get_default_model_factory
    fasta = FIX + {"dna": "/dna12.fasta", "codon": "/orf10.fasta"}[name]
    opts = Options(sequence_file=fasta, engine="native",
                   dna_flag=name == "dna", codon_flag=name == "codon",
                   cmodel_file=FIX + "/dna.qmat" if name == "dna" else "",
                   **flags)
    spec = get_alphabet(opts)
    seqs, _ = read_fasta(fasta)
    enc = {n: spec.encode(s) for n, s in seqs.items()}
    factory = get_default_model_factory(
        opts, spec, {n: spec.values(s) for n, s in enc.items()})
    return spec, enc, _balanced(sorted(enc)), {}, factory, opts


def _run(monkeypatch, inp, batches=True):
    """The level scheduler on the host over ``inp``: its levels' tasks and
    node results (from ``align_tasks``), and its stderr."""
    spec, seqs, tree, reps, factory, opts = inp
    levels = []
    with monkeypatch.context() as m:
        if not batches:
            m.setattr(native, "batches", lambda options: False)
        recording(m, ld, "align_tasks", levels)
        _res, err = stderr_of(ld.progressive_alignment_batched, spec, seqs,
                              tree, reps, None, factory, opts, device=None)
    return [(a[0], [r for r, _n in out], [n for _r, n in out])
            for a, out in levels], err


def _hold_level(tasks, factory, opts, spec):
    """One level's batch, array by array: the cleanings against
    clean_graph, the merges against the port's and the JAX package's
    merge_graphs, the row blocks against the JAX package's
    extend_alignment."""
    graphs = [r.graph for t in tasks for r in t[:2]]
    for g, (cg, om), in zip(graphs, gr.clean_graphs(graphs, opts)):
        want, want_om = gr.clean_graph(g, opts)
        assert (cg is g) == (want is g)
        _same_padded(cg, want, "clean")
        _same_arrays(om, want_om, "outmapping")
    preps = [prog.prealign_node(r1, r2, d1, d2, factory, opts)
             for r1, r2, d1, d2, _s1, _s2 in tasks]
    alns = [prog.align_graphs(p[3], p[5], p[0], opts)[0] for p in preps]
    ancs = mg.merge_graphs_batch(
        [(r1.graph, r2.graph, a.mapping1, a.mapping2, p[4], p[6], p[1], p[2],
          s1, s2) for (r1, r2, _d1, _d2, s1, s2), a, p
         in zip(tasks, alns, preps)], opts)
    for (r1, r2, _d1, _d2, s1, s2), a, p, anc in zip(tasks, alns, preps,
                                                     ancs):
        one = prog.merge_node(r1, r2, a, p, s1, s2, opts)
        ref = ref_merge.merge_graphs(
            r1.graph, r2.graph, gr.unclean_mapping(a.mapping1, p[4]),
            gr.unclean_mapping(a.mapping2, p[6]), p[1], p[2], s1, s2, opts)
        for want, who in ((one, "port"), (ref, "jax")):
            _same_padded(anc.graph, want.graph, "merge vs " + who)
            for x, y, nm in ((anc.mapping1, want.mapping1, "m1"),
                             (anc.mapping2, want.mapping2, "m2"),
                             (anc.is_matched, want.is_matched, "matched")):
                assert np.asarray(x).tolist() == list(y), nm
    blocks = prog.extend_blocks(
        [(anc.graph.size, ((anc.mapping1, t[0]), (anc.mapping2, t[1])))
         for t, anc in zip(tasks, ancs)], spec.gap_code)
    for t, anc, (cols, names) in zip(tasks, ancs, blocks):
        ref = ref_prog.ProgressiveAlignmentResult()
        ref.graph = anc.graph
        for mapping, child in ((anc.mapping1, t[0]), (anc.mapping2, t[1])):
            ref_prog.extend_alignment(ref, list(mapping),
                                      child.aligned_sequences, spec.gap_code)
        assert names == list(ref.aligned_sequences)
        for r, nm in enumerate(names):
            _same_arrays(cols[:, r], ref.aligned_sequences[nm], nm)


def _same_runs(a, b):
    (levels_a, err_a), (levels_b, err_b) = a, b
    assert err_a == err_b
    assert len(levels_a) == len(levels_b)
    for (_ta, ra, na), (_tb, rb, nb) in zip(levels_a, levels_b):
        assert na == nb
        for x, y in zip(ra, rb):
            same_result(x, y)
            _same_padded(x.graph, y.graph, "node graph")
            assert list(x.profiles) == list(y.profiles)
            for nm in x.profiles:
                _same_arrays(x.profiles[nm], y.profiles[nm], nm)


INPUTS = [("fam20", {}), ("rep8", {}), ("dna", {}), ("codon", {}),
          ("fam6", {"ancestral_flag": True})]


@pytest.mark.parametrize("name,flags", INPUTS,
                         ids=[n + "".join("-" + k for k in f)
                              for n, f in INPUTS])
def test_batch_equals_node_path_and_jax(name, flags, monkeypatch):
    """Every level's node results equal the per-node path's (and its TR
    lines); every level's cleanings, merges and row blocks equal the
    per-node functions' and the JAX package's, array by array."""
    inp = _input(name, **flags)
    got = _run(monkeypatch, inp)
    _same_runs(got, _run(monkeypatch, inp, batches=False))
    spec, _seqs, _tree, _reps, factory, opts = inp
    for tasks, _res, _ntr in got[0]:
        _hold_level(tasks, factory, opts, spec)
    if name == "rep8":
        assert "TR indels at" in got[1]
        assert any(r.tr_homologies for _t, res, _n in got[0] for r in res)
    if flags:   # the ancestral rows: children's dicts that left a block
        assert any(prog.row_block(t[0]) is None and t[0].block is not None
                   for tasks, _r, _n in got[0] for t in tasks)


def test_batch_equals_the_python_bodies(monkeypatch):
    """fam20's levels with the batches against the library switched off
    (every stage's Python body, as PROGRAPHMSA_NATIVE=0 leaves it)."""
    inp = _input("fam20")
    got = _run(monkeypatch, inp)
    with monkeypatch.context() as m:
        m.setattr(native, "_lib", None)
        m.setattr(native, "_tried", True)
        assert not native.batches(inp[-1])
        want = _run(monkeypatch, inp)
    _same_runs(got, want)


@pytest.mark.parametrize("seed", range(3))
def test_random_trees(seed, monkeypatch):
    """Random trees over fam20's sequences, random supports (0 and 1
    among them: no penalty, and the full one), alternative-splicing
    probabilities from 1e-300 (an unused edge of a fully supported branch
    costs about 1,000 more a level) to 0.7: batch against the per-node
    path, and every level array by array."""
    rng = np.random.default_rng(seed)
    asp = [1e-300, 0.328125, 0.7][seed]
    spec, seqs, _tree, reps, factory, opts = _input(
        "fam20", altsplice_prob=asp)
    names = sorted(seqs)[:int(rng.integers(8, 21))]
    inp = (spec, {n: seqs[n] for n in names}, _balanced(names, rng), reps,
           factory, opts)
    got = _run(monkeypatch, inp)
    _same_runs(got, _run(monkeypatch, inp, batches=False))
    for tasks, _res, _ntr in got[0]:
        _hold_level(tasks, factory, opts, spec)


def _cut(g, rng, share):
    """``g`` with ``share`` of its finite normal edges at infinite cost."""
    idx, cost, isrep, units = (a.copy() for a in g.padded())
    cut = (idx >= 0) & ~isrep & np.isfinite(cost) & (
        rng.random(cost.shape) < share)
    cost[cut] = np.inf
    return gr.Graph.from_padded(g.sites.copy(), idx, cost, isrep, units)


@pytest.mark.parametrize("seed", range(2))
def test_clean_batch_on_cut_graphs(seed, monkeypatch):
    """fam20's and rep8's merged graphs with a random share of their
    edges at infinite cost, so that the cleaning drops nodes (or, where no
    finite path is left, fails its invariant): the batch against
    clean_graph's native branch, its Python body and the JAX package's
    clean_graph, at repeat extension 0.3 and 0."""
    from prographmsa_tpu.graph import graph as ref_gr
    rng = np.random.default_rng(seed)
    dropped = 0
    for name in ("fam20", "rep8"):
        inp = _input(name)
        levels, _err = _run(monkeypatch, inp)
        opts = inp[-1].replace(repeatext_prob=[0.3, 0.0][seed])
        graphs = [_cut(r.graph, rng, float(rng.choice([0.02, 0.1, 0.3])))
                  for _t, res, _n in levels for r in res]
        kept = []
        for g in graphs:
            try:
                want, want_om = gr.clean_graph(g, opts)
            except AssertionError:
                with pytest.raises(AssertionError):
                    gr.clean_graphs([g], opts)
                continue
            kept.append((g, want, want_om))
            dropped += want.size < g.size
            body, body_om = gr.clean_graph(g, opts.replace(engine="numpy"))
            ref, ref_om = ref_gr.clean_graph(g, opts)
            for other, om in ((body, body_om), (ref, ref_om)):
                _same_padded(want, other, "clean")
                _same_arrays(want_om, om, "outmapping")
        got = gr.clean_graphs([g for g, _w, _o in kept], opts)
        for (g, want, want_om), (cg, om) in zip(kept, got):
            assert cg is not g
            _same_padded(cg, want, "clean batch")
            _same_arrays(om, want_om, "outmapping")
    assert dropped


def test_threads_give_identical_results(monkeypatch):
    """fam20 at 1, 2, 3 and 8 threads: the same levels, bit for bit.  The
    batches' grain is lowered to one unit of work a thread, so that each
    kind of batch call runs on as many threads as its widest batch has
    items, up to the pool: 7 nodes at the first level, so 14 graphs to
    clean, of which the first level's leaves need no copy (its cleaning
    finishes on the widest later level's graphs)."""
    inp = _input("fam20")
    runs = []
    native.batch_probe(1)
    try:
        for t in (1, 2, 3, 8):
            monkeypatch.setenv("PROGRAPHMSA_THREADS", str(t))
            runs.append(_run(monkeypatch, inp))
            used = native.batch_probe(1)
            widths = [len(tasks) for tasks, _r, _n in runs[-1][0]]
            widest = {k: max(widths) for k in native.BATCH_KINDS}
            widest["clean_begin"] = 2 * max(widths)
            widest["clean_finish"] = 2 * max(widths[1:])
            assert used == {k: min(t, w) for k, w in widest.items()}, \
                (t, used)
    finally:
        native.batch_probe(0)
    for other in runs[1:]:
        _same_runs(runs[0], other)


def test_single_row_child_and_leaf():
    """A node whose children are a leaf (its sequence, no block) and a
    one-row block, and a child without rows: the batch's block equals the
    JAX package's extension."""
    rng = np.random.default_rng(5)
    for _ in range(20):
        n_cols = int(rng.integers(1, 40))
        children = []
        for kind in ("leaf", "block", "empty"):
            k = int(rng.integers(0, n_cols + 1))
            at = np.sort(rng.permutation(n_cols)[:k])
            m = np.full(n_cols + 2, -1, np.int32)
            m[0], m[-1] = 0, n_cols + 1
            m[1 + at] = np.arange(1, k + 1)
            res = prog.ProgressiveAlignmentResult()
            row = rng.integers(0, 30, k + int(rng.integers(0, 3))
                               ).astype(np.int16)
            if kind == "leaf":
                res.aligned_sequences = {"leaf": row}
            elif kind == "block":
                res.block = prog.RowBlock(np.ascontiguousarray(row[:, None]),
                                          ["one"])
                res.aligned_sequences = {"one": res.block.rows[0]}
            children.append((m, res))
        (cols, names), = prog.extend_blocks([(n_cols + 2, children)], 45)
        ref = ref_prog.ProgressiveAlignmentResult()
        ref.graph = gr.Graph(np.zeros((n_cols + 2, 1)), None, None)
        for m, ch in children:
            ref_prog.extend_alignment(ref, m.tolist(), ch.aligned_sequences,
                                      45)
        assert names == list(ref.aligned_sequences) == ["leaf", "one"]
        for r, nm in enumerate(names):
            _same_arrays(cols[:, r], ref.aligned_sequences[nm], nm)


def _spy_node_path(monkeypatch):
    """Calls that complete of the per-node functions a retry would run."""
    calls = []
    for mod, name in ((mg, "merge_graphs"), (prog, "merge_node"),
                      (prog, "extend_children"), (gr, "clean_graph")):
        recording(monkeypatch, mod, name, calls)
    return calls


def test_a_failing_batch_fails_the_run(monkeypatch):
    """A batch call that cannot allocate (the library returns no staged
    batch) raises out of the run, and no node is merged another way."""
    inp = _input("fam6")
    monkeypatch.setattr(native.lib(), "gc_merge_batch_begin",
                        lambda *a: None)
    calls = _spy_node_path(monkeypatch)
    with pytest.raises(MemoryError, match="gc_merge_batch_begin"):
        _run(monkeypatch, inp)
    assert not calls


def test_sizes_that_disagree_are_an_error(monkeypatch):
    """A staged batch whose sizes say a merged node has no padded width
    raises; the run is not retried node by node."""
    inp = _input("fam6")
    L = native.lib()
    real = L.gc_merge_batch_begin

    def corrupt(B, dims, ptrs, ups, gemv, ddot, blas64, sizes, nt):
        h = real(B, dims, ptrs, ups, gemv, ddot, blas64, sizes, nt)
        (ctypes.c_int32 * (3 * B)).from_address(sizes)[2] = 0
        return h

    monkeypatch.setattr(L, "gc_merge_batch_begin", corrupt)
    with pytest.raises(RuntimeError, match="width 0"):
        _run(monkeypatch, inp)


def test_a_raising_clean_batch_is_not_retried(monkeypatch):
    inp = _input("fam6")

    def fail(*a, **kw):
        raise RuntimeError("clean batch failed")

    monkeypatch.setattr(native, "clean_batch", fail)
    calls = _spy_node_path(monkeypatch)
    with pytest.raises(RuntimeError, match="clean batch failed"):
        _run(monkeypatch, inp)
    assert not calls


CLI = [("t_fam20.fasta", ["--fasta", "-t", G + "/tree0_fam20.nwk",
                          FIX + "/fam20.fasta"]),
       ("r_fam20.fasta", ["--fasta", "-r", FIX + "/fam20.fasta"]),
       ("c5_rep8_t.fasta", ["--fasta", "--read_repeats", FIX + "/rep8.trd",
                            "-t", G + "/tree0_rep8.nwk",
                            FIX + "/rep8.fasta"])]


@pytest.mark.parametrize("threads", ["1", "8"])
@pytest.mark.parametrize("golden,args", CLI, ids=[c[0] for c in CLI])
def test_native_cli_golden(golden, args, threads, tmp_path, monkeypatch):
    """The native tier's CLI at one thread and eight: each golden, output
    and stderr."""
    monkeypatch.setenv("PROGRAPHMSA_THREADS", threads)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    out = str(tmp_path / "out")
    stderr = run_cli(args + ["--engine", "native"], out,
                     module="prographmsa_tpu_torch.cli")
    _check(golden, out, stderr)
    assert os.path.getsize(out) > 0
