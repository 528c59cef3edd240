"""The native BioNJ (``native/graphcore.cpp`` ``gc_bionj``) over a team of
threads: its column sums, Q scan and compaction split D's columns over
the team, so its joins, branch lengths and the 3 x 3 D it leaves must be
the same bits at 1, 2, 3 and 8 threads, and its trees those of the port's
numpy loop (``tree/nj.py`` with the library off) and of the JAX package's
``build_nj_tree``.  The grain is lowered to one cell a thread
(``native.batch_probe(1)``) so that even n = 4 runs the whole team;
``native.bionj_probe`` reports the threads each call ran on.  Cases: odd
and even n from 4 to 300, exact ties in Q, a NaN row of D, and a forced
join plan that covers only the first steps.
"""

import zlib

import numpy as np
import pytest

from prographmsa_tpu.config import Options as RefOptions
from prographmsa_tpu.tree import nj as ref_nj
from prographmsa_tpu_torch import native
from prographmsa_tpu_torch.config import Options
from prographmsa_tpu_torch.tree import nj

from test_torch_tree_native import _additive, _grid, _signature, _sym

THREADS = (1, 2, 3, 8)
# name -> (n, D's kind, a plan of the first joins or None)
CASES = {
    "random_4": (4, "random", None),
    "random_5": (5, "random", None),
    "random_64": (64, "random", None),
    "random_65": (65, "random", None),
    "random_300": (300, "random", None),
    "additive_ties_40": (40, "additive", None),
    "additive_ties_41": (41, "additive", None),
    "grid_ties_50": (50, "grid", None),
    "nan_row_60": (60, "nan_row", None),
    "plan_prefix_80": (80, "random", [(0, 1), (5, 78), (2, 3), (40, 70)]),
    "plan_prefix_grid_33": (33, "grid", [(3, 4), (0, 31)]),
}


def _case(name):
    n, kind, plan = CASES[name]
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    if kind == "random":
        D, V = _sym(rng, n), _sym(rng, n, 0.1)
    elif kind == "additive":
        D = _additive(rng, n)
        V = D * 0.1
    elif kind == "grid":
        D, V = _grid(rng, n), _grid(rng, n) * 0.01
    else:
        D, V = _sym(rng, n), _sym(rng, n, 0.1)
        D[7, :] = D[:, 7] = np.nan
    return ["s%d" % i for i in range(n)], D, V, plan


@pytest.fixture
def grain_of_one():
    """Every call of the library's threaded paths on as many threads as
    it may take, the count of threads read from zero."""
    native.batch_probe(1)
    native.bionj_probe()
    yield
    native.batch_probe(0)


def _trees(names, D, V, plan, monkeypatch, threads):
    """The port's tree with the library at each thread count, the numpy
    loop's, the JAX package's, and each native call's arrays."""
    opts = Options()
    topo = None
    if plan is not None:
        # a forced plan of the first joins only: build_nj_tree asks
        # build_topo_plan for the plan of a topology
        topo = object()
        monkeypatch.setattr(nj, "build_topo_plan", lambda order, t: plan)
        monkeypatch.setattr(ref_nj, "build_topo_plan",
                            lambda order, t: plan)
    raw, used, mine = [], [], []
    with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
        for t in threads:
            monkeypatch.setenv("PROGRAPHMSA_THREADS", str(t))
            raw.append(native.bionj_native(D, V, plan or []))
            used.append(native.bionj_probe())
            mine.append(nj.build_nj_tree(names, D, V, opts, topo))
            native.bionj_probe()
        with monkeypatch.context() as m:
            m.setattr(native, "lib", lambda: None)
            numpy_path = nj.build_nj_tree(names, D, V, opts, topo)
        theirs = ref_nj.build_nj_tree(names, D, V,
                                      RefOptions(engine="native"), topo)
    return raw, used, mine, numpy_path, theirs


@pytest.mark.parametrize("name", list(CASES))
def test_threaded_bionj_bit_identical(name, grain_of_one, monkeypatch):
    names, D, V, plan = _case(name)
    raw, used, mine, numpy_path, theirs = _trees(names, D, V, plan,
                                                 monkeypatch, THREADS)
    assert used == list(THREADS)
    one = raw[0]
    assert one is not None
    for t, arrays in zip(THREADS, raw):
        for a, b in zip(arrays, one):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), t
    want = _signature(numpy_path)
    assert _signature(theirs) == want
    for t, tree in zip(THREADS, mine):
        assert _signature(tree) == want, t
    if plan is not None:
        assert one[0][:len(plan)].tolist() == [list(p) for p in plan]


def test_threaded_bionj_refuses_a_plan_pair_out_of_range(grain_of_one,
                                                         monkeypatch):
    """A forced pair that is no pair of the current rows ends the team's
    call with None, as it ends the one-thread call."""
    rng = np.random.default_rng(4)
    D, V = _sym(rng, 40), _sym(rng, 40, 0.1)
    for t in THREADS:
        monkeypatch.setenv("PROGRAPHMSA_THREADS", str(t))
        assert native.bionj_native(D, V, [(0, 1), (2, 39)]) is None
        assert native.bionj_native(D, V, [(3, 3)]) is None
        assert native.bionj_native(D, V, [(0, 1), (2, 38)]) is not None


@pytest.mark.parametrize("n,threads,want", [
    (100, 8, 1),       # 10,000 cells: less than one thread's grain
    (362, 8, 1),       # 131,044 cells: still under two threads' grain
    (363, 8, 2),
    (500, 8, 3),
    (725, 8, 8),
    (725, 3, 3),
    (1000, 1, 1),
])
def test_bionj_team_follows_its_grain(n, threads, want, monkeypatch):
    """At its own grain (a thread for each 2^16 cells of D, up to
    PROGRAPHMSA_THREADS) a small D runs on the calling thread alone; the
    result is the same bits whatever the team."""
    native.batch_probe(0)
    native.bionj_probe()
    rng = np.random.default_rng(n)
    D, V = _sym(rng, n), _sym(rng, n, 0.1)
    monkeypatch.setenv("PROGRAPHMSA_THREADS", str(threads))
    got = native.bionj_native(D, V, [])
    assert native.bionj_probe() == want
    monkeypatch.setenv("PROGRAPHMSA_THREADS", "1")
    one = native.bionj_native(D, V, [])
    for a, b in zip(got, one):
        assert a.tobytes() == b.tobytes()
