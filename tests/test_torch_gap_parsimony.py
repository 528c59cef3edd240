"""The port's batched gap-parsimony scorer (``score_alignments`` in
prographmsa_tpu_torch/engine/gap_parsimony.py: every edge's root alignment
in one bit-packed Fitch pass over one rooting of the graph) against the
JAX package's recursion (``score_alignment`` in
prographmsa_tpu/engine/gap_parsimony.py: one alignment at a time, from its
own root edge), edge by edge and exactly: on every edge of the corpus's
root searches under ``-r`` (fam6, fam20, rep8 with their golden trees and
fam6 on a tree whose root has three children), on a seeded fuzz of random
unrooted binary trees and gap matrices, and the ``root_score`` phase that
the port's ``--timings`` reports around the scoring.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from prographmsa_tpu.engine import find_root as ref_fr
from prographmsa_tpu.engine import gap_parsimony as ref_gp

from prographmsa_tpu_torch.engine import find_root as fr
from prographmsa_tpu_torch.engine import gap_parsimony as gp

from test_e2e_differential import FIX, G, REPO
from test_torch_find_root import run_jax, run_port, setup

# the trifurcating tree of test_torch_find_root.py
TRI = ("(seq000:0.143329,(seq001:0.0734223,seq005:0.0717077):0.192735,"
       "(seq002:0.0684431,(seq003:0.0499723,seq004:0.149721):0.0878116)"
       ":0.0717933);\n")


@pytest.mark.parametrize("name,tri", [("fam6", False), ("fam20", False),
                                      ("rep8", False), ("fam6", True)])
def test_scores_match_jax_on_every_edge_of_the_corpus(name, tri, tmp_path,
                                                      monkeypatch):
    """Each package's ``-r`` search (the port's waves on the host), then
    every edge's root alignment scored: the port's in one call, the JAX
    package's edge by edge on its own graph."""
    tree_file = None
    if tri:
        tree_file = str(tmp_path / "tri.nwk")
        with open(tree_file, "w") as f:
            f.write(TRI)
    _ref, ref_err, ref_edges = run_jax(name, 1, monkeypatch, tree_file)
    _res, err, edges = run_port(name, 1, monkeypatch, None, tree_file)
    # (rep8's TR lines come in the JAX package's thread order)
    assert err.splitlines()[-1] == ref_err.splitlines()[-1]
    gap = setup("prographmsa_tpu_torch", name)[0].gap_code
    want = [ref_gp.score_alignment(e.alignment, e, gap) for e in ref_edges]
    assert len(edges) == len(want)
    assert gp.score_alignments(edges, gap) == want
    assert [gp.score_alignment(e.alignment, e, gap) for e in edges] == want
    assert err.endswith("best gap parsimony score: %g\n" % min(want))


class _Alignment:
    def __init__(self, rows):
        self.aligned_sequences = rows


def _random_tree(rng, n_leaves, tri):
    """A random rooted binary tree (nested tuples, leaves are names) whose
    root has three children when ``tri``."""
    items = ["s%02d" % i for i in range(n_leaves)]
    while len(items) > (3 if tri else 2):
        i, j = sorted(rng.choice(len(items), 2, replace=False))
        b, a = items.pop(j), items.pop(i)
        items.append((a, b))
    return tuple(items)


def _graph(mod, tree):
    """``mod``'s node/edge graph of ``tree`` in the order its
    ``tree_graph`` builds it: a root of two children is one edge, a root of
    three a node of three edges.  Returns the edges."""
    edges = []

    def grow(n, t):
        if isinstance(t, str):
            n.name = t
        else:
            link(n, 1, t[0])
            link(n, 2, t[1])

    def link(parent, slot, t):
        e = mod.Edge()
        edges.append(e)
        n = mod.Node()
        n.edges[0] = e
        e.nodes[0], e.nodes[1] = parent, n
        parent.edges[slot] = e
        grow(n, t)

    if len(tree) == 3:
        n0 = mod.Node()
        for i, t in enumerate(tree):
            link(n0, i, t)
    else:
        e0 = mod.Edge()
        edges.append(e0)
        for i, t in enumerate(tree):
            n = mod.Node()
            n.edges[0] = e0
            e0.nodes[i] = n
            grow(n, t)
    return edges


GAP = 45
WIDTHS = [1, 7, 63, 64, 65, 128, 129, 200]


def _random_rows(rng, leaves, width):
    """A leaf row each, plus an ancestral row that no score reads: columns
    all gap, gap-free or gapped at a random rate."""
    kind = rng.integers(0, 3, size=width)
    rate = np.where(kind == 0, 1.0, np.where(kind == 1, 0.0,
                                             rng.random(width)))
    names = list(leaves) + ["(" + ",".join(sorted(leaves)) + ")"]
    gapped = rng.random((len(names), width)) < rate
    codes = np.where(gapped, GAP, rng.integers(0, 20, (len(names), width)))
    return dict(zip(names, codes.astype(np.int16)))


@pytest.mark.parametrize("seed", range(8))
def test_scores_match_jax_on_random_trees(seed, monkeypatch):
    """Trees of 2-64 leaves, roots of two and three children, each edge
    with an alignment of its own (widths 1-200, on and off multiples of
    64; all-gap and gap-free columns): every edge's score, in one call
    over all edges, over a random subset (another rooting, as a step of
    ``-r -r`` scores) and one alignment a chunk, equals the JAX package's
    recursion on its own graph."""
    rng = np.random.default_rng(seed)
    for trial in range(6):
        n_leaves = [2, 3, 4][trial] if seed == 0 and trial < 3 else \
            int(rng.integers(4, 65))
        tri = n_leaves >= 3 and bool(rng.integers(0, 2))
        tree = _random_tree(rng, n_leaves, tri)
        edges, ref_edges = _graph(fr, tree), _graph(ref_fr, tree)
        leaves = ["s%02d" % i for i in range(n_leaves)]
        for e, re_ in zip(edges, ref_edges):
            w = int(rng.choice(WIDTHS)) if rng.random() < 0.5 else \
                int(rng.integers(1, 201))
            e.alignment = re_.alignment = _Alignment(
                _random_rows(rng, leaves, w))
        want = [ref_gp.score_alignment(e.alignment, e, GAP)
                for e in ref_edges]
        assert gp.score_alignments(edges, GAP) == want
        pick = rng.permutation(len(edges))[:max(1, len(edges) // 3)]
        assert gp.score_alignments([edges[i] for i in pick], GAP) == \
            [want[i] for i in pick]
        with monkeypatch.context() as m:
            m.setattr(gp, "_CHUNK_WORDS", 1)
            assert gp.score_alignments(edges, GAP) == want


def test_no_edges_no_scores():
    assert gp.score_alignments([], GAP) == []


def _cli(args, out):
    env = dict(os.environ, PYTHONWARNINGS="ignore", OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "prographmsa_tpu_torch.cli", *args,
         "--engine", "native", "--device", "cpu", "-o", out],
        cwd=REPO, check=True, env=env, capture_output=True, timeout=600)
    with open(out) as f:
        return proc.stdout.decode(), proc.stderr.decode(), f.read()


def _phases(stderr):
    head, _, report = stderr.partition("timings (wall seconds")
    return head, [ln.split()[0] for ln in report.splitlines()[1:]
                  if ln.startswith("  ") and not ln.startswith("   ")]


@pytest.mark.parametrize("flags,golden", [
    (["-r"], "r_fam20.fasta"),
    (["-r", "-r"], None),
    (["-t", G + "/tree0_fam20.nwk"], "t_fam20.fasta")])
def test_timings_report_root_score_only_under_r(flags, golden, tmp_path):
    """``--timings`` names the scoring ``root_score`` under ``-r`` and
    ``-r -r`` and not without; stdout, the output file and the stderr
    before the report are those of the run without ``--timings``."""
    args = ["--fasta", *flags, FIX + "/fam20.fasta"]
    plain = _cli(args, str(tmp_path / "plain"))
    timed = _cli(["--timings", *args], str(tmp_path / "timed"))
    head, phases = _phases(timed[1])
    assert (timed[0], head, timed[2]) == plain
    assert "total" in phases and "merge" in phases
    assert ("root_score" in phases) == ("-r" in flags)
    if golden:
        with open(os.path.join(G, golden)) as f:
            assert plain[2] == f.read()
