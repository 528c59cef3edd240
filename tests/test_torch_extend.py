"""The port's row extension (prographmsa_tpu_torch/engine/progressive.py:
``extend_children``, ``RowBlock``) against the JAX package's
``extend_alignment``, which extends a child's rows one stacked scatter at
a time.  Exact: the same names in the same order and equal rows.

A seeded fuzz of mappings and row counts, with children that hold their
rows in a block, in a plain dict, or in a block their dict no longer
matches; then every node of fam20's fixed-tree level batch and every slot
of fam6's root search (``-r``) against the JAX package's results; then the
``--timings`` phase ``extend`` on a fam6 CLI run, and (``slow``) fam500's
``-r -i 0`` output against its golden.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from prographmsa_tpu.engine import find_root as ref_fr
from prographmsa_tpu.engine import progressive as ref_prog

from prographmsa_tpu_torch.engine import find_root as fr
from prographmsa_tpu_torch.engine import level_driver as ld
from prographmsa_tpu_torch.engine import progressive as prog

from test_e2e_differential import FIX, G, REPO
from test_torch_find_root import recording, same_result, setup, stderr_of

GAP = 45


class _Graph:
    def __init__(self, size):
        self.size = size


def _rows(rng, names, width):
    codes = rng.integers(0, 24, (len(names), width))
    codes[rng.random(codes.shape) < 0.3] = GAP
    return {nm: r for nm, r in zip(names, codes.astype(np.int16))}


def _mapping(rng, n_cols, k):
    """A mapping of a merged graph of ``n_cols`` columns (plus its start
    and end node) that maps ``k`` of them, in order; at random an unmapped
    run at either end."""
    lo = min(int(rng.integers(0, 4)) if rng.random() < 0.6 else 0, n_cols)
    hi = min(int(rng.integers(0, 4)) if rng.random() < 0.6 else 0,
             n_cols - lo)
    inner = n_cols - lo - hi
    k = min(k, inner)
    at = lo + np.sort(rng.permutation(inner)[:k])
    m = np.full(n_cols + 2, -1, dtype=np.int64)
    m[0], m[-1] = 0, n_cols + 1
    m[1 + at] = np.arange(1, k + 1)
    return m.tolist(), k


def _reference(n_cols, children):
    """The JAX package's extension of each (mapping, rows) in turn."""
    ref = ref_prog.ProgressiveAlignmentResult()
    ref.graph = _Graph(n_cols + 2)
    for mapping, rows in children:
        ref_prog.extend_alignment(ref, mapping, rows, GAP)
    return ref.aligned_sequences


def _same_rows(got, want):
    assert list(got) == list(want)
    for nm in want:
        assert got[nm].dtype == np.int16
        assert np.array_equal(got[nm], want[nm]), nm


def _extended(n_cols, children):
    """The port's ``extend_children`` of (mapping, child result) pairs."""
    res = prog.ProgressiveAlignmentResult()
    res.graph = _Graph(n_cols + 2)
    prog.extend_children(res, children, GAP)
    return res


def _child(rng, names, width, kind):
    """A child result holding ``names``' rows of ``width`` columns: as a
    leaf or a plain dict (``dict``), or as extended from two grandchildren
    into a block (``block``)."""
    res = prog.ProgressiveAlignmentResult()
    if kind == "dict" or len(names) < 2:
        res.aligned_sequences = _rows(rng, names, width)
        return res
    cut = int(rng.integers(1, len(names)))
    parts = []
    for part in (names[:cut], names[cut:]):
        k = int(rng.integers(0, width + 1))
        mapping, k = _mapping(rng, width, k)
        grand = prog.ProgressiveAlignmentResult()
        grand.aligned_sequences = _rows(rng, part, k + int(rng.integers(0, 3)))
        parts.append((mapping, grand))
    res = _extended(width, parts)
    assert prog.row_block(res) is not None
    return res


@pytest.mark.parametrize("seed", range(6))
def test_extension_matches_jax_on_random_mappings(seed):
    """Two to four children (a node's two, or the subalignments that early
    refinement re-aligns) of 0-64 rows each (leaves, plain dicts and
    blocks), mappings with unmapped runs at both ends and children longer
    than their mapped count: ``extend_children`` equals the JAX package's
    ``extend_alignment`` of each child in turn, row for row, and the
    result's dict is its block."""
    rng = np.random.default_rng(seed)
    for trial in range(24):
        n_cols = int(rng.integers(1, 120))
        counts = [int(rng.integers(0, 65))
                  for _ in range(int(rng.integers(2, 5)))]
        if trial < 3:
            counts = [[0, 1], [1, 1], [0, 0]][trial]
        names = ["s%03d" % i for i in range(sum(counts))]
        bounds = np.concatenate([[0], np.cumsum(counts)])
        children = []
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            mapping, k = _mapping(rng, n_cols,
                                  int(rng.integers(0, n_cols + 1)))
            kind = ("dict", "block")[int(rng.integers(0, 2))]
            width = k + int(rng.integers(0, 4))
            children.append((mapping,
                             _child(rng, names[lo:hi], width, kind)))
        want = _reference(n_cols, [(m, ch.aligned_sequences)
                                   for m, ch in children])
        res = _extended(n_cols, children)
        _same_rows(res.aligned_sequences, want)
        block = prog.row_block(res)
        assert block is not None and block.names == names
        assert block.cols.shape == (n_cols, len(names))
        for row in res.aligned_sequences.values():
            assert np.shares_memory(row, block.cols)


@pytest.mark.parametrize("rows", [1, 2])
def test_one_row_children(rows):
    """Leaves (one row, the sequence itself, no block) beside a child of
    ``rows`` rows: each extended as the JAX package does."""
    rng = np.random.default_rng(7)
    for _ in range(20):
        n_cols = int(rng.integers(1, 60))
        children = []
        for names in (["a"], ["b%d" % i for i in range(rows)]):
            mapping, k = _mapping(rng, n_cols,
                                  int(rng.integers(0, n_cols + 1)))
            children.append((mapping, _child(rng, names, k, "block")))
        want = _reference(n_cols, [(m, ch.aligned_sequences)
                                   for m, ch in children])
        _same_rows(_extended(n_cols, children).aligned_sequences, want)


def _stale(rng, child, how):
    """Change ``child``'s dict after its block was made."""
    rows = child.aligned_sequences
    width = len(next(iter(rows.values())))
    if how == "ancestral":
        # prelim_ancestral_seq / final_ancestral_seq add a row
        rows[prog.create_ancestral_seq_name(rows)] = \
            _rows(rng, ["x"], width)["x"]
    elif how == "filtered":
        # the CLI drops the "(" rows of its result
        child.aligned_sequences = {n: s for n, s in rows.items()
                                   if not n.startswith("(")}
    elif how == "replaced":
        first = next(iter(rows))
        rows[first] = _rows(rng, [first], width)[first]
    elif how == "reordered":
        child.aligned_sequences = dict(reversed(list(rows.items())))


@pytest.mark.parametrize("how", ["ancestral", "filtered", "replaced",
                                 "reordered"])
def test_a_dict_that_left_its_block_is_read_row_by_row(how):
    """A child whose dict gained an ancestral row, lost a ``(`` row,
    had a row replaced or changed its order after its block was made: the
    block is not trusted (``row_block`` is None) and the extension reads
    the dict, as the JAX package does."""
    rng = np.random.default_rng(11)
    for _ in range(10):
        width = int(rng.integers(2, 40))
        names = ["s%02d" % i for i in range(int(rng.integers(3, 12)))]
        if how == "filtered":
            names[-1] = "(" + ",".join(names[:-1]) + ")"
        child = _child(rng, names, width, "block")
        assert prog.row_block(child) is not None
        _stale(rng, child, how)
        assert prog.row_block(child) is None
        other = _child(rng, ["t0", "t1"], width, "block")
        n_cols = width + int(rng.integers(0, 5))
        children = []
        for ch in (child, other):
            children.append((_mapping(rng, n_cols, width)[0], ch))
        want = _reference(n_cols, [(m, ch.aligned_sequences)
                                   for m, ch in children])
        _same_rows(_extended(n_cols, children).aligned_sequences, want)


def test_a_new_dict_of_the_same_rows_keeps_its_block():
    """The CLI's filter on a result without ``(`` rows builds a new dict of
    the same views in the same order: still the block's rows."""
    rng = np.random.default_rng(3)
    child = _child(rng, ["a", "b", "c"], 9, "block")
    child.aligned_sequences = {n: s for n, s in
                               child.aligned_sequences.items()
                               if not n.startswith("(")}
    assert prog.row_block(child) is child.block


@pytest.mark.parametrize("how", [None, "ancestral", "replaced"])
def test_gap_flags_read_the_block_or_the_rows(how):
    """``gap_flags`` hands the root scorer the gap flags of a result's rows
    as (columns, rows) in a scratch buffer, with the rows of the names it
    asked for: the block whole while it holds the dict's rows, else the
    asked rows read one by one."""
    rng = np.random.default_rng(5)
    for _ in range(10):
        width = int(rng.integers(1, 50))
        names = ["s%02d" % i for i in range(int(rng.integers(2, 12)))]
        child = _child(rng, names, width, "block")
        if how is not None:
            _stale(rng, child, how)
        ask = list(rng.permutation(names))
        rows = child.aligned_sequences
        buf = np.full(width * max(len(rows), len(ask)), 7, dtype=np.uint8)
        flags, at = prog.gap_flags(child, ask, GAP, buf)
        assert flags.shape[0] == width
        assert np.shares_memory(flags, buf)
        want = np.stack([rows[nm] for nm in ask]) == GAP
        assert np.array_equal(flags[:, at].T, want)


def _node_key(res):
    return tuple(sorted(res.aligned_sequences))


def _counting_reads(monkeypatch):
    """Record the size of each dict that the extension reads row by row."""
    sizes = []
    read = prog._read_rows

    def counted(rows, k):
        sizes.append(len(rows))
        return read(rows, k)

    monkeypatch.setattr(prog, "_read_rows", counted)
    return sizes


def test_fam20_level_batch_matches_jax_node_by_node(monkeypatch):
    """Every node of fam20's fixed-tree level batch equals the JAX
    package's sequential result for the same node, and only leaves were
    read row by row: every inner child was extended from its block."""
    spec, seqs, tree, reps, factory, opts = setup("prographmsa_tpu", "fam20")
    ref_nodes = []
    recording(monkeypatch, ref_prog, "align_progressive_results", ref_nodes)
    ref_prog.progressive_alignment(spec, seqs, tree, reps, None, factory,
                                   opts)
    spec, seqs, tree, reps, factory, opts = setup("prographmsa_tpu_torch",
                                                  "fam20")
    batches = []
    recording(monkeypatch, ld, "align_tasks", batches)
    reads = _counting_reads(monkeypatch)
    ld.progressive_alignment_batched(spec, seqs, tree, reps, None, factory,
                                     opts, device=None)
    got = {_node_key(res): res for _a, out in batches for res, _n in out}
    want = {_node_key(out): out for _a, out in ref_nodes}
    assert len(got) == len(want) == len(seqs) - 1
    assert len(batches) > 1
    for key, res in want.items():
        same_result(got[key], res)
        assert prog.row_block(got[key]) is not None
    assert reads == [1] * len(seqs)


def test_fam6_root_search_matches_jax_slot_by_slot(monkeypatch):
    """Under ``-r`` on fam6 every directional slot and every edge's root
    alignment of the port equals the JAX package's; only leaves were read
    row by row."""
    spec, seqs, tree, reps, factory, opts = setup(
        "prographmsa_tpu", "fam6", reroot_flag=1)
    seen = []
    recording(monkeypatch, ref_fr, "_precompute_all_directional", seen)
    stderr_of(ref_fr.progressive_alignment_find_root, spec, seqs, tree,
              reps, None, factory, opts)
    ref_nodes, ref_edges = seen[0][0][:2]
    spec, seqs, tree, reps, factory, opts = setup(
        "prographmsa_tpu_torch", "fam6", reroot_flag=1)
    graphs = []
    recording(monkeypatch, fr, "tree_graph", graphs)
    reads = _counting_reads(monkeypatch)
    stderr_of(fr.progressive_alignment_find_root, spec, seqs, tree, reps,
              None, factory, opts, None, "torch")
    nodes, edges = graphs[0][1]
    n_slots = 0
    for a, b in zip(nodes, ref_nodes):
        if a.is_leaf():
            continue
        for i in range(3):
            same_result(a.cached[i], b.cached[i])
            assert prog.row_block(a.cached[i]) is not None
            n_slots += 1
    assert n_slots == 3 * (len(seqs) - 2)
    assert len(edges) == len(ref_edges) == 2 * len(seqs) - 3
    for e, re_ in zip(edges, ref_edges):
        same_result(e.alignment, re_.alignment)
    assert reads and set(reads) == {1}


def _cli(args, out, timeout):
    env = dict(os.environ, PYTHONWARNINGS="ignore", OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "prographmsa_tpu_torch.cli", *args,
         "--engine", "native", "--device", "cpu", "-o", out],
        cwd=REPO, check=True, env=env, capture_output=True, timeout=timeout)
    with open(out) as f:
        return proc.stderr.decode(), f.read()


def test_timings_report_extend(tmp_path):
    """``--timings`` on a fam6 ``-r`` run names ``extend``, once a merged
    node (the passes' and the root search's, as ``merge``), beside
    ``root_score``; the output is the golden's."""
    err, out = _cli(["--timings", "--fasta", "-r", FIX + "/fam6.fasta"],
                    str(tmp_path / "r6"), 300)
    head, _, report = err.partition("timings (wall seconds")
    calls = {ln.split()[0]: int(ln.rsplit(",", 1)[1].split()[0])
             for ln in report.splitlines()[1:]
             if ln.startswith("  ") and "calls)" in ln}
    assert calls["extend"] == calls["merge"] >= 3 * (6 - 2) + 2 * 6 - 3
    assert "root_score" in calls
    with open(os.path.join(G, "r_fam6.fasta")) as f:
        assert out == f.read()
    with open(os.path.join(G, "r_fam6.stderr")) as f:
        assert head == f.read()


@pytest.mark.slow
def test_fam500_root_search_output_is_golden(tmp_path):
    """fam500 (500 x 278-319 aa) ``-r -i 0``: the root search extends
    about a million rows; output and score line are the golden's."""
    err, out = _cli(["--fasta", "-r", "-i", "0", FIX + "/fam500.fasta"],
                    str(tmp_path / "r500"), 900)
    with open(os.path.join(G, "fam500_r_i0.fasta")) as f:
        assert out == f.read()
    with open(os.path.join(G, "fam500_r_i0.stderr")) as f:
        assert err == f.read()
