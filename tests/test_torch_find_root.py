"""The port's root search (prographmsa_tpu_torch/engine/find_root.py:
``-r``, ``-r -r``) against the JAX package's (its host engine, ``native``)
and against the port's own sequential recursion (the lazy
``Node.get_alignment`` / ``Edge.get_alignment``), on fam6, fam20 and rep8
with their golden trees.  The port's waves run on ``device=cpu`` (the DP
kernels' plain PyTorch versions); on rep8, whose long repeat graphs take
the plain fill minutes, they stay on the host (``device=None``): the
schedule and the TR lines' order are the same code either way, and the
corpus (tests/test_torch_cli*.py's rep8 cases) runs repeat pairs through
the plain kernels.  Exact: equal aligned sequences, graphs, scores,
``n_tr_indels``, gap-parsimony scores and stderr lines.
"""

import contextlib
import importlib
import io

import numpy as np
import pytest
import torch

from prographmsa_tpu.engine import find_root as ref_fr
from prographmsa_tpu.engine import gap_parsimony as ref_gp

from prographmsa_tpu_torch.engine import find_root as fr
from prographmsa_tpu_torch.engine import gap_parsimony as gp
from prographmsa_tpu_torch.engine.level_driver import HostPool

from test_e2e_differential import FIX, G

CPU = torch.device("cpu")
INPUTS = {
    "fam6": (FIX + "/fam6.fasta", G + "/tree0_fam6.nwk", None),
    "fam20": (FIX + "/fam20.fasta", G + "/tree0_fam20.nwk", None),
    "rep8": (FIX + "/rep8.fasta", G + "/tree0_rep8.nwk", FIX + "/rep8.trd"),
}


def setup(pkg, name, tree_file=None, **flags):
    """(spec, sequences, tree, repeats, factory, options) of one input for
    the package ``pkg``, as its CLI's do_align builds them on the host;
    ``tree_file`` replaces the input's golden tree."""
    mod = lambda m: importlib.import_module(pkg + "." + m)
    fasta, golden_tree, trd = INPUTS[name]
    tree_file = tree_file or golden_tree
    if trd:
        flags["repeats_flag"] = 1
    opts = mod("config").Options(sequence_file=fasta, engine="native",
                                 **flags)
    spec = mod("alphabet").get_alphabet(opts)
    seqs, _ = mod("io.fasta").read_fasta(fasta)
    enc = {}
    for n, s in seqs.items():
        e = spec.encode(s)
        if len(e) and e[0] == spec.encode(spec.strip_start)[0]:
            e = e[1:]
        enc[n] = e
    factory = mod("models.factory").get_default_model_factory(
        opts, spec, {n: spec.values(s) for n, s in enc.items()})
    with open(tree_file) as f:
        tree = mod("io.newick").parse_newick(f.read())
    reps = mod("repeats_treks").read_repeats(trd, enc, spec) if trd else {}
    return spec, enc, tree, reps, factory, opts


def same_graph(a, b):
    assert a.size == b.size
    assert np.array_equal(a.sites, b.sites)
    for i in range(a.size):
        assert [(p, np.float32(c)) for p, c in a.preds[i]] == \
            [(p, np.float32(c)) for p, c in b.preds[i]], i
        assert [tuple(r) for r in a.reps[i]] == \
            [tuple(r) for r in b.reps[i]], i


def same_result(a, b):
    assert list(a.aligned_sequences) == list(b.aligned_sequences)
    for n in a.aligned_sequences:
        assert np.array_equal(a.aligned_sequences[n],
                              b.aligned_sequences[n]), n
    assert np.float32(a.score) == np.float32(b.score)
    assert a.n_tr_indels == b.n_tr_indels
    assert len(a.tr_homologies) == len(b.tr_homologies)
    for x, y in zip(a.tr_homologies, b.tr_homologies):
        assert np.array_equal(x, y)
    assert a.tr_source == b.tr_source
    same_graph(a.graph, b.graph)


def stderr_of(fn, *args, **kw):
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        out = fn(*args, **kw)
    return out, err.getvalue()


def recording(monkeypatch, module, name, sink):
    """Wrap ``module.name`` so that each call's (arguments, result) lands in
    ``sink``."""
    orig = getattr(module, name)

    def wrapped(*a, **kw):
        out = orig(*a, **kw)
        sink.append((a, out))
        return out

    monkeypatch.setattr(module, name, wrapped)


def run_jax(name, reroot, monkeypatch, tree_file=None):
    """The JAX package's root search; its graph's edges (``-r``: every
    edge's root alignment cached)."""
    spec, seqs, tree, reps, factory, opts = setup(
        "prographmsa_tpu", name, tree_file, reroot_flag=reroot)
    seen = []
    recording(monkeypatch, ref_fr, "_precompute_all_directional", seen)
    res, err = stderr_of(ref_fr.progressive_alignment_find_root, spec, seqs,
                         tree, reps, None, factory, opts)
    return res, err, (seen[0][0][1] if seen else None)


def run_port(name, reroot, monkeypatch, device=CPU, tree_file=None):
    spec, seqs, tree, reps, factory, opts = setup(
        "prographmsa_tpu_torch", name, tree_file, reroot_flag=reroot)
    graphs = []
    recording(monkeypatch, fr, "tree_graph", graphs)
    res, err = stderr_of(fr.progressive_alignment_find_root, spec, seqs,
                         tree, reps, None, factory, opts, device, "torch")
    return res, err, graphs[0][1][1]


@pytest.mark.parametrize("name,reroot", [("fam6", 1), ("fam6", 2),
                                         ("fam20", 1), ("fam20", 2)])
def test_root_search_matches_jax(name, reroot, monkeypatch):
    """The best root's alignment and the score line; under ``-r`` every
    edge's root alignment and both packages' gap-parsimony score of it."""
    ref, ref_err, ref_edges = run_jax(name, reroot, monkeypatch)
    res, err, edges = run_port(name, reroot, monkeypatch)
    same_result(res, ref)
    assert err == ref_err and err.startswith("best gap parsimony score: ")
    if reroot == 1:
        gap = setup("prographmsa_tpu_torch", name)[0].gap_code
        assert len(edges) == len(ref_edges)
        for e, re_ in zip(edges, ref_edges):
            same_result(e.alignment, re_.alignment)
            assert gp.score_alignment(e.alignment, e, gap) == \
                ref_gp.score_alignment(re_.alignment, re_, gap)
    else:
        # the climb reads only the edges round its path
        assert sum(e.alignment is not None for e in edges) < len(edges)


@pytest.mark.parametrize("reroot", [1, 2])
def test_root_search_on_a_trifurcating_tree_matches_jax(reroot, tmp_path,
                                                        monkeypatch):
    """A user's tree whose root has three children (``-r -t`` aligns no
    pass before the search, so nothing else reads it)."""
    tree = tmp_path / "tri.nwk"
    tree.write_text("(seq000:0.143329,(seq001:0.0734223,seq005:0.0717077)"
                    ":0.192735,(seq002:0.0684431,(seq003:0.0499723,"
                    "seq004:0.149721):0.0878116):0.0717933);\n")
    ref, ref_err, _ = run_jax("fam6", reroot, monkeypatch, str(tree))
    res, err, edges = run_port("fam6", reroot, monkeypatch, CPU, str(tree))
    assert len(edges) == 2 * 6 - 3
    same_result(res, ref)
    assert err == ref_err


@pytest.mark.parametrize("name", ["fam6", "fam20"])
def test_waves_fill_every_slot_as_the_recursion(name, monkeypatch):
    """Every directional slot and every edge's root alignment of the
    batched schedule (waves on the plain kernels) equals the sequential
    recursion's, and the batches are fewer than the alignments."""
    spec, seqs, tree, reps, factory, opts = setup("prographmsa_tpu_torch",
                                                  name, reroot_flag=1)
    args = (spec, seqs, tree, reps, None, factory, opts)
    nodes_a, edges_a = fr.tree_graph(*args)
    for e in edges_a:
        e.get_alignment(factory, opts, spec)
    nodes_b, edges_b = fr.tree_graph(*args)
    batches = []
    recording(monkeypatch, fr, "align_tasks", batches)
    with HostPool() as pool:
        search = fr.BatchedRootSearch(factory, opts, spec, CPU, "torch",
                                      pool)
        search.align_edges(edges_b)
    n_slots = 0
    for a, b in zip(nodes_a, nodes_b):
        for i in range(3):
            assert (a.cached[i] is None) == (b.cached[i] is None)
            if a.cached[i] is not None and not a.is_leaf():
                same_result(b.cached[i], a.cached[i])
                n_slots += 1
    for a, b in zip(edges_a, edges_b):
        same_result(b.alignment, a.alignment)
        assert gp.score_alignment(b.alignment, b, spec.gap_code) == \
            gp.score_alignment(a.alignment, a, spec.gap_code)
    n_leaves = sum(n.is_leaf() for n in nodes_a)
    assert n_slots == 3 * (n_leaves - 2)
    sizes = [len(a[0]) for a, _ in batches]
    assert sum(sizes) == n_slots + len(edges_a)
    assert sizes[-1] == len(edges_a)        # the root edges, one batch
    assert 4 * len(sizes) <= sum(sizes)


def _tr_lines(err):
    return [ln for ln in err.splitlines() if ln.startswith("TR indels at")]


def test_tr_lines_in_the_recursions_order_under_r(monkeypatch):
    """``-r`` with repeats: the TR lines in the order the sequential
    recursion computes the alignments (edges[0], then edges[1:]), not the
    order of the waves; the JAX package prints the same lines in its
    threads' order."""
    spec, seqs, tree, reps, factory, opts = setup("prographmsa_tpu_torch",
                                                  "rep8", reroot_flag=1)
    _nodes, edges = fr.tree_graph(spec, seqs, tree, reps, None, factory,
                                  opts)

    def sequential():
        for e in edges:
            e.get_alignment(factory, opts, spec)

    _, seq_err = stderr_of(sequential)
    res, err, _edges = run_port("rep8", 1, monkeypatch, None)
    lines = _tr_lines(err)
    assert len(lines) == 3 * (len(seqs) - 2) + len(edges)
    assert lines == _tr_lines(seq_err)
    ref, ref_err, _ = run_jax("rep8", 1, monkeypatch)
    assert sorted(_tr_lines(ref_err)) == sorted(lines)
    same_result(res, ref)


def test_tr_lines_of_the_hill_climb_match_jax(monkeypatch):
    """``-r -r`` with repeats: the JAX package's climb aligns lazily, in
    the recursion's order; the port's batched climb prints the same
    stderr."""
    ref, ref_err, _ = run_jax("rep8", 2, monkeypatch)
    res, err, _ = run_port("rep8", 2, monkeypatch, None)
    assert _tr_lines(err) and err == ref_err
    same_result(res, ref)
