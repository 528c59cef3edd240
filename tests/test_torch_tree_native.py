"""The first guide tree's native stages (``native/graphcore.cpp``
``gc_angle_gram`` and ``gc_bionj``) against the JAX package's
``compute_angle_distances`` and ``build_nj_tree`` and against the port's
own numpy path (the native library off), bit for bit: distances and
variances as float64 bits, trees in full (leaf names, topology, the bits of
every branch length and support).  NJ breaks ties on the last bit, so a
rounding that differs anywhere shows as another tree.
"""

import importlib.util
import os
import zlib

import numpy as np
import pytest

from prographmsa_tpu import alphabet as ref_al
from prographmsa_tpu.config import Options as RefOptions
from prographmsa_tpu.distances import angle as ref_angle
from prographmsa_tpu.io import newick as ref_newick
from prographmsa_tpu.tree import nj as ref_nj
from prographmsa_tpu_torch import alphabet as al
from prographmsa_tpu_torch import native
from prographmsa_tpu_torch.config import Options
from prographmsa_tpu_torch.distances import angle
from prographmsa_tpu_torch.eigen_compat import _redux_contiguous
from prographmsa_tpu_torch.io import newick
from prographmsa_tpu_torch.io.fasta import read_fasta
from prographmsa_tpu_torch.tree import nj

from test_e2e_differential import FIX, G, REPO
from test_torch_cli import run_port_case


def _make_family(n, length, seed):
    path = os.path.join(REPO, "tools", "make_fixtures.py")
    spec = importlib.util.spec_from_file_location("make_fixtures", path)
    mf = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mf)
    return mf.make_family(n, length, mf.AA, seed)


def _bits(x):
    return int(np.float64(x).view(np.int64))


def _signature(tree):
    """Preorder rows (name, length bits, support bits, children)."""
    rows, stack = [], [tree]
    while stack:
        node = stack.pop()
        rows.append((node.name, _bits(node.branch_length),
                     _bits(node.branch_support), len(node.children)))
        stack.extend(reversed(node.children))
    return rows


@pytest.fixture
def library_off(monkeypatch):
    """Runs a callable with the native library unavailable, as under
    PROGRAPHMSA_NATIVE=0."""
    def run(fn, *args):
        with monkeypatch.context() as m:
            m.setattr(native, "lib", lambda: None)
            return fn(*args)
    return run


# ---------------------------------------------------------------------
# Eigen's packet sum

@pytest.mark.parametrize("aligned_start", [0, 1])
def test_packet_sum_matches_eigen_compat(aligned_start):
    """gc_redux_sum (the column sums of gc_bionj) against
    eigen_compat._redux_contiguous, lengths 1-67, one to nine columns at a
    time (four go side by side), values over six decades."""
    L = native.lib()
    assert L is not None
    rng = np.random.default_rng(11 + aligned_start)
    for n in range(1 + aligned_start, 68):
        for count in (1, 3, 4, 9):
            M = rng.random((count, n)) * 10.0 ** rng.uniform(-3, 3,
                                                            (count, n))
            out = np.empty(count)
            L.gc_redux_sum(n, count, native._d(M), aligned_start,
                           native._d(out))
            want = np.array([_redux_contiguous(M[k], aligned_start)
                             for k in range(count)])
            assert np.array_equal(out.view(np.int64), want.view(np.int64)), \
                (n, count)


# ---------------------------------------------------------------------
# Angle distances

def _family(case):
    """(options' keywords, {name: sequence})."""
    if case == "fam20":
        return {}, read_fasta(FIX + "/fam20.fasta")[0]
    if case == "fam200_seeded":
        return {}, _make_family(200, 300, 7)
    if case == "dna12_k6":
        return dict(dna_flag=True), read_fasta(FIX + "/dna12.fasta")[0]
    if case == "orf10_codon":
        return dict(codon_flag=True), read_fasta(FIX + "/orf10.fasta")[0]
    assert case == "fam6_short"
    seqs = read_fasta(FIX + "/fam6.fasta")[0]
    seqs["short"] = "W"        # shorter than k: no k-mers, a NaN row
    return {}, seqs


def _inputs(case):
    """Each package's options, alphabet and encoded family, and the order."""
    kw, seqs = _family(case)
    opts, ropts = Options(**kw), RefOptions(engine="native", **kw)
    spec, rspec = al.get_alphabet(opts), ref_al.get_alphabet(ropts)
    enc = {n: spec.encode(s) for n, s in seqs.items()}
    renc = {n: rspec.encode(s) for n, s in seqs.items()}
    return (opts, spec, enc), (ropts, rspec, renc), sorted(seqs)


def _port_angle(case):
    (opts, spec, enc), _, order = _inputs(case)
    return order, angle.compute_angle_distances(spec, enc, order, opts)


ANGLE_CASES = ["fam20", "fam200_seeded", "dna12_k6", "orf10_codon",
               "fam6_short"]


@pytest.mark.parametrize("case", ANGLE_CASES)
def test_angle_distances_bit_identical(case, library_off, monkeypatch):
    calls = []
    gram = native.angle_gram_native
    monkeypatch.setattr(native, "angle_gram_native",
                        lambda *a: calls.append(gram(*a)) or calls[-1])
    (opts, spec, enc), (ropts, rspec, renc), order = _inputs(case)
    mine = angle.compute_angle_distances(spec, enc, order, opts)
    numpy_path = library_off(angle.compute_angle_distances, spec, enc,
                             order, opts)
    theirs = ref_angle.compute_angle_distances(rspec, renc, order, ropts)
    assert calls[0] is not None and calls[1] is None, \
        "the native Gram did not run, or ran with the library off"
    for m, p, t in zip(mine, numpy_path, theirs):
        assert m.shape == (len(order), len(order))
        assert np.array_equal(m.view(np.int64), t.view(np.int64))
        assert np.array_equal(p.view(np.int64), t.view(np.int64))
    if case == "dna12_k6":
        assert spec.kmer_k == 6
    if case == "fam6_short":
        assert np.isnan(mine[0][order.index("short")]).all()


# ---------------------------------------------------------------------
# BioNJ

def _sym(rng, n, scale=1.0):
    a = rng.random((n, n)) * scale
    return a + a.T


def _additive(rng, n):
    """A tree metric of integer branch lengths in quarters: every quartet
    meets the four-point condition exactly, so Q ties everywhere."""
    clusters = [{i: 0.0} for i in range(n)]
    D = np.zeros((n, n))
    while len(clusters) > 1:
        a = clusters.pop(rng.integers(len(clusters)))
        b = clusters.pop(rng.integers(len(clusters)))
        la, lb = rng.integers(1, 4, 2) * 0.25
        for i, di in a.items():
            for j, dj in b.items():
                D[i, j] = D[j, i] = di + la + dj + lb
        clusters.append({**{i: d + la for i, d in a.items()},
                         **{j: d + lb for j, d in b.items()}})
    return D


def _grid(rng, n):
    a = np.triu(rng.integers(1, 4, (n, n)) * 0.5, 1)
    return a + a.T


def _nj_case(case):
    """(names, D, V, newick of a forced topology or None)."""
    rng = np.random.default_rng(zlib.crc32(case.encode()))
    if case.startswith("random_"):
        n = int(case.split("_")[1])
        return (["s%d" % i for i in range(n)], _sym(rng, n),
                _sym(rng, n, 0.1), None)
    n = 24
    names = ["t%02d" % i for i in range(n)]
    if case == "asymmetric":
        return names, rng.random((n, n)), rng.random((n, n)) * 0.1, None
    if case == "additive_ties":
        D = _additive(rng, n)
        return names, D, D * 0.1, None
    if case == "additive_ties_odd":
        D = _additive(rng, n + 1)
        return names + ["t24"], D, np.full((n + 1, n + 1), 0.01), None
    if case == "grid_ties":
        return names, _grid(rng, n), _grid(rng, n) * 0.01, None
    if case == "nan_row":
        D, V = _sym(rng, n), _sym(rng, n, 0.1)
        D[5, :] = D[:, 5] = np.nan
        return names, D, V, None
    if case == "inf_entries":
        D, V = _sym(rng, n), _sym(rng, n, 0.1)
        D[2, 9] = D[9, 2] = np.inf
        D[7, 1] = np.inf
        V[3, 4] = V[4, 3] = np.inf
        return names, D, V, None
    if case == "zero_variances":
        return names, _sym(rng, n), np.zeros((n, n)), None
    if case == "angle_nan_row":
        order, (D, V) = _port_angle("fam6_short")
        return order, D, V, None
    order, (D, V) = _port_angle("fam20")
    np.fill_diagonal(D, 0.0)
    np.fill_diagonal(V, 0.0)
    if case == "fam20_angle":
        return order, D, V, None
    assert case == "fam20_topology"
    with open(G + "/tree0_fam20.nwk") as f:
        return order, D, V, f.read()


NJ_CASES = ["random_2", "random_3", "random_4", "random_5", "random_16",
            "random_17", "random_301", "asymmetric", "additive_ties",
            "additive_ties_odd", "grid_ties", "nan_row", "inf_entries",
            "zero_variances", "angle_nan_row", "fam20_angle",
            "fam20_topology"]


@pytest.mark.parametrize("case", NJ_CASES)
def test_bionj_tree_bit_identical(case, library_off, monkeypatch):
    names, D, V, topo = _nj_case(case)
    opts, ropts = Options(), RefOptions(engine="native")
    t_mine = newick.parse_newick(topo) if topo else None
    t_ref = ref_newick.parse_newick(topo) if topo else None
    calls = []
    bionj = native.bionj_native
    monkeypatch.setattr(native, "bionj_native",
                        lambda *a: calls.append(bionj(*a)) or calls[-1])
    with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
        mine = nj.build_nj_tree(names, D, V, opts, t_mine)
        numpy_path = library_off(nj.build_nj_tree, names, D, V, opts,
                                 t_mine)
        theirs = ref_nj.build_nj_tree(names, D, V, ropts, t_ref)
    if len(names) > 3:
        assert calls[0] is not None and calls[1] is None, \
            "the native BioNJ did not run, or ran with the library off"
    assert _signature(mine) == _signature(theirs)
    assert _signature(numpy_path) == _signature(theirs)


def test_bionj_leaves_its_inputs():
    rng = np.random.default_rng(3)
    D, V = _sym(rng, 9), _sym(rng, 9, 0.1)
    D0, V0 = D.copy(), V.copy()
    joins, lengths, d_end = native.bionj_native(D, V, [])
    assert np.array_equal(D, D0) and np.array_equal(V, V0)
    assert joins.shape == (6, 2) and lengths.shape == (6, 2)
    assert d_end.shape == (3, 3)
    assert (joins[:, 0] < joins[:, 1]).all()


def test_bionj_refuses_a_plan_pair_out_of_range():
    """A forced pair that is no pair of the current rows gives None (the
    numpy loop then takes the plan as it stands)."""
    rng = np.random.default_rng(4)
    D, V = _sym(rng, 6), _sym(rng, 6, 0.1)
    assert native.bionj_native(D, V, [(0, 1), (2, 5)]) is None
    assert native.bionj_native(D, V, [(1, 1)]) is None
    assert native.bionj_native(D, V, [(0, 5), (1, 2)]) is not None


# ---------------------------------------------------------------------
# The CLI

@pytest.mark.parametrize("library", ["1", "0"])
def test_cli_fam20_i0_golden_with_native_on_and_off(library, tmp_path,
                                                    monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("PROGRAPHMSA_NATIVE", library)
    run_port_case("i0_fam20.fasta", ["--fasta", "-i", "0",
                                      FIX + "/fam20.fasta"], tmp_path)
