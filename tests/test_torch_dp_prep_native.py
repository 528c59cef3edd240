"""The card path's batch preparation in native code: the slot tables
(``native/graphcore.cpp`` ``gc_offset_slots`` + ``gc_offset_costs``, bound
as ``native.offset_costs_native``, reached through ``slots.offset_costs_rep``
and ``slots.capped_offset_costs``) and the launch planes (``gc_pack_planes``,
``native.pack_planes_native``, reached through ``graph_dp_cuda.pack_pairs``)
against the numpy bodies (``slots._offset_costs_rep_numpy``,
``graph_dp_cuda._planes_numpy``) and the JAX package's
``_offset_costs_rep`` and ``_prep_pair``, bit for bit: offsets, C viewed as
uint32 (so -0.0 and 0.0 differ), rep; every Batch tensor viewed as
integers, its plan, Rmax and Lm.  Inputs: every graph of fam20's ``-r``
batches, rep8's graphs (also with an infinite repeat extension: NaN
one-unit repeat costs), and a seeded fuzz of padded graphs (ties of 0.0
and -0.0, NaN, +-inf and huge costs, one offset in both kinds, offsets
reached only by NaN repeat edges, holes in rows, exactly ``max_offsets``
slots and one more, no edges).  Spies show which body runs, with the
library and with ``native.lib`` returning None; a library that raises or
disagrees on the slot count is an error, never retried in numpy.
"""

from types import SimpleNamespace

import numpy as np
import pytest

import dp_prep_time
from prographmsa_tpu.align import graph_dp_pallas as ref_gdp
from prographmsa_tpu_torch import checks, native
from prographmsa_tpu_torch.align import graph_dp_cuda as gdp
from prographmsa_tpu_torch.align import slots
from prographmsa_tpu_torch.graph.graph import Graph

from test_e2e_differential import FIX, G
from test_torch_find_root import setup, stderr_of

def _u32(a):
    return np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)


def _same_tables(got, want):
    """(offsets, C, rep) bit for bit, or both None."""
    assert (got is None) == (want is None)
    if got is None:
        return
    (o, C, r), (o2, C2, r2) = got, want
    assert o.dtype == o2.dtype == np.int32 and np.array_equal(o, o2)
    assert C.dtype == C2.dtype == np.float32 and C.shape == C2.shape
    assert np.array_equal(_u32(C), _u32(C2))
    assert r.dtype == r2.dtype == np.bool_ and np.array_equal(r, r2)


def _jax_capped(C):
    """The JAX package's cap (graph_dp_pallas._prep_pair)."""
    return np.where(np.isfinite(C), C, ref_gdp.COST_INF).astype(np.float32)


def _hold(g, sc, max_offsets):
    """Native tables, uncapped and capped, against the numpy body and the
    JAX package's loop; returns the native uncapped tables."""
    assert native.lib() is not None, "the native library did not build"
    mine = slots.offset_costs_rep(g, sc, max_offsets)
    _same_tables(mine, slots._offset_costs_rep_numpy(g, sc, max_offsets))
    jax_ = ref_gdp._offset_costs_rep(g, sc, max_offsets)
    _same_tables(mine, jax_)
    capped = slots.capped_offset_costs(g, sc, max_offsets)
    if jax_ is None:
        assert capped is None
    else:
        _same_tables(capped, (jax_[0], _jax_capped(jax_[1]), jax_[2]))
        numpy_ = slots._offset_costs_rep_numpy(g, sc, max_offsets)
        _same_tables(capped, (numpy_[0], slots.inf_to_cap(numpy_[1]),
                              numpy_[2]))
    return mine


# ---------------------------------------------------------------------------
# the slice's graphs


@pytest.fixture(scope="module")
def fam20_r_batches():
    """Every batch fam20's root search sends to the card path, recorded
    through dp_prep_time (the CLI's output held against its golden)."""
    batches, text, _ = dp_prep_time.record(
        ["--fasta", "-r", FIX + "/fam20.fasta"])
    with open(G + "/r_fam20.fasta") as f:
        assert f.read() == text
    assert len(batches) > 20
    return batches


@pytest.fixture(scope="module")
def rep8_items():
    """rep8's root search and early refinement batches, as
    test_torch_host_layers.py records them."""
    from prographmsa_tpu_torch.engine import find_root, level_driver

    items = []
    orig = level_driver.align_items

    def recorded(its, *a):
        items.extend(its)
        return orig(its, *a)

    level_driver.align_items = recorded
    try:
        for flags in (dict(reroot_flag=1), dict(earlyref_flag=True)):
            spec, seqs, tree, reps, fac, opts = setup(
                "prographmsa_tpu_torch", "rep8", **flags)
            run = (find_root.progressive_alignment_find_root
                   if opts.reroot_flag
                   else level_driver.progressive_alignment_batched)
            stderr_of(run, spec, seqs, tree, reps, None, fac, opts, None)
    finally:
        level_driver.align_items = orig
    return items


def test_fam20_r_graphs(fam20_r_batches):
    """Every graph of fam20's -r batches, each table against the numpy
    body and the JAX loop, and each pair's capped tables against the JAX
    package's _prep_pair."""
    n = 0
    for items in fam20_r_batches:
        for k, (g1, g2, m, sc) in enumerate(items):
            for g in (g1, g2):
                assert _hold(g, sc, slots.MAX_OFF) is not None
                n += 1
            p, ref = gdp.prep_pair(k, g1, g2, m, sc), ref_gdp._prep_pair(
                k, g1, g2, m, sc)
            for a, b in (("o1", "o1"), ("o2", "o2")):
                assert np.array_equal(getattr(p, a), getattr(ref, b))
            for f in ("C1", "C2"):
                assert np.array_equal(_u32(getattr(p, f)),
                                      _u32(getattr(ref, f)))
            assert np.array_equal(p.rep1, ref.rep1)
            assert np.array_equal(p.rep2, ref.rep2)
    assert n > 200


@pytest.mark.parametrize("ext", ["as_run", "inf"])
def test_rep8_graphs(rep8_items, ext):
    """rep8's repeat graphs; with an infinite repeat extension their
    one-unit repeat edges cost NaN (inf * 0): such an edge makes a slot
    but never a cost or a flag."""
    n_reps = 0
    for g1, g2, _m, sc in rep8_items:
        if ext == "inf":
            sc = SimpleNamespace(repeat_init=sc.repeat_init,
                                 repeat_ext=np.float32(np.inf))
        for g in (g1, g2):
            n_reps += any(g.reps)
            _hold(g, sc, slots.MAX_OFF)
    assert n_reps > 0


def test_dp_prep_time_holds_both_bodies_on_fam20(fam20_r_batches):
    """The timing script's comparison: prep and pack over fam20's batches
    with the library and without it, bit for bit."""
    res = dp_prep_time.compare(fam20_r_batches)
    assert res["identical"]
    assert res["launches"] >= len(fam20_r_batches)
    for body in ("native", "numpy"):
        assert len(res[body]["prep_s"]) == 1


# ---------------------------------------------------------------------------
# seeded fuzz

COSTS = np.array([0.0, -0.0, 0.25, 1.5, np.nan, np.inf, -np.inf, 2e37,
                  3.0], np.float32)


def _scores(ri=8.154821, re=1.7369655):
    return SimpleNamespace(repeat_init=np.float32(ri),
                           repeat_ext=np.float32(re))


def _graph(idx, cost, isrep, units, dim=20, seed=0):
    n = idx.shape[0]
    sites = np.random.default_rng(seed).random((n, dim))
    return Graph.from_padded(sites, np.ascontiguousarray(idx, np.int32),
                             np.ascontiguousarray(cost, np.float32),
                             np.ascontiguousarray(isrep, np.bool_),
                             np.ascontiguousarray(units, np.int32))


def fuzz_graph(rng, n, E, holes=True, dim=20, max_skip=12, p_rep=0.25):
    """A padded graph of n nodes: per row up to E entries, normal edges
    (costs from COSTS or random, a predecessor repeated for ties) then
    repeat edges (units 0-7), some rows with a hole before their last
    entry."""
    idx = np.full((n, E), -1, np.int32)
    cost = np.full((n, E), np.inf, np.float32)
    isrep = np.zeros((n, E), np.bool_)
    units = np.zeros((n, E), np.int32)
    for i in range(1, n):
        k = int(rng.integers(1, E + 1))
        preds = rng.integers(max(0, i - max_skip), i, k)
        kinds = np.sort(rng.random(k) < p_rep)        # normals first
        vals = np.where(rng.random(k) < 0.5, COSTS[rng.integers(
            0, len(COSTS), k)], rng.random(k).astype(np.float32))
        cols = np.arange(k)
        if holes and k < E and rng.random() < 0.2:
            cols[-1] = E - 1
        idx[i, cols] = preds
        isrep[i, cols] = kinds
        cost[i, cols] = np.where(kinds, np.inf, vals)
        units[i, cols] = np.where(kinds, rng.integers(0, 8, k), 0)
    return _graph(idx, cost, isrep, units, dim, int(rng.integers(1 << 30)))


@pytest.mark.parametrize("seed", range(10))
def test_fuzz_graphs(seed):
    """Random padded graphs under four repeat scorings (the run's, a zero
    extension, an infinite one: NaN one-unit costs, a negative one)."""
    rng = np.random.default_rng(seed)
    g = fuzz_graph(rng, int(rng.integers(2, 80)), int(rng.integers(1, 7)))
    for sc in (_scores(), _scores(re=0.0), _scores(re=np.inf),
               _scores(ri=-0.0, re=-np.inf)):
        _hold(g, sc, slots.MAX_OFF)
        _hold(g, sc, 1 << 20)


def _rows(n, E, rows):
    """A padded graph of n nodes from {node: [(pred, cost or None for a
    repeat edge, units)]}."""
    idx = np.full((n, E), -1, np.int32)
    cost = np.full((n, E), np.inf, np.float32)
    isrep = np.zeros((n, E), np.bool_)
    units = np.zeros((n, E), np.int32)
    for i, es in rows.items():
        for c, (p, v, u) in enumerate(es):
            idx[i, c] = p
            isrep[i, c] = v is None
            cost[i, c] = np.inf if v is None else v
            units[i, c] = u
    return _graph(idx, cost, isrep, units)


CASES = {
    # 0.0 before -0.0 keeps 0.0, -0.0 before 0.0 keeps -0.0, a NaN first
    # or last never wins, and -inf and +inf cap alike
    "ties": (_rows(6, 4, {1: [(0, 0.0, 0), (0, -0.0, 0)],
                          2: [(1, -0.0, 0), (1, 0.0, 0), (0, 1.0, 0)],
                          3: [(2, np.nan, 0), (2, 2.0, 0), (2, np.nan, 0)],
                          4: [(3, -np.inf, 0), (2, np.inf, 0)],
                          5: [(4, 2e37, 0), (3, np.nan, 0)]}), _scores()),
    # offset 1 both normal and repeat: two slots; equal repeat costs
    # tie on units
    "both_kinds": (_rows(5, 4, {1: [(0, 0.5, 0)],
                                2: [(1, 0.5, 0), (1, None, 2)],
                                3: [(2, 1.0, 0), (1, None, 3),
                                    (1, None, 3)],
                                4: [(3, 0.0, 0), (2, None, 1)]}),
                   _scores(ri=0.0, re=0.0)),
    # offset 3 reached only by a one-unit repeat edge of NaN cost
    "nan_only_repeat": (_rows(5, 3, {1: [(0, 1.0, 0)],
                                     2: [(1, 1.0, 0)],
                                     3: [(2, 1.0, 0), (0, None, 1)],
                                     4: [(3, 1.0, 0), (2, None, 2)]}),
                        _scores(re=np.inf)),
    "no_edges": (_rows(4, 2, {}), _scores()),
    "one_node": (_rows(1, 1, {}), _scores()),
}


@pytest.mark.parametrize("name", list(CASES))
def test_edge_cases(name):
    g, sc = CASES[name]
    o, C, rep = _hold(g, sc, slots.MAX_OFF)
    if name in ("no_edges", "one_node"):
        assert o.tolist() == [1] and C.shape == (g.size, 1)
        assert not rep.any() and np.isinf(C).all()
        _hold(g, sc, 0)
        assert slots.offset_costs_rep(g, sc, -1) is None
        assert slots._offset_costs_rep_numpy(g, sc, -1) is None
    if name == "ties":
        assert _u32(C[1]).tolist()[0] == _u32(np.float32(0.0)).item()
        assert _u32(C[2]).tolist()[0] == _u32(np.float32(-0.0)).item()
    if name == "both_kinds":           # offset 1 counts twice
        assert len(set(o.tolist())) < len(o)
        assert _hold(g, sc, len(o)) is not None
        assert _hold(g, sc, len(o) - 1) is None
    if name == "nan_only_repeat":
        k = o.tolist().index(3)
        assert k < 2 and not rep[:, k].any() and np.isinf(C[:, k]).all()


@pytest.mark.parametrize("seed", range(4))
def test_exactly_max_offsets_and_one_more(seed):
    """A graph of k slots fits max_offsets = k and gives None at k - 1 in
    all three versions; an offset used by both kinds counts twice."""
    rng = np.random.default_rng(100 + seed)
    g = fuzz_graph(rng, 120, 5, max_skip=40, p_rep=0.4)
    sc = _scores()
    k = len(_hold(g, sc, 1 << 20)[0])
    assert k > 8
    assert _hold(g, sc, k) is not None
    assert _hold(g, sc, k - 1) is None


# ---------------------------------------------------------------------------
# launch planes


def _prep_items(rng, sizes, E, dim=20):
    m = checks.model(0.5)
    sc = checks.DynProgScores(checks.chain("ACDE"), checks.chain("ACDE"),
                              m, checks.OPTS)
    items = []
    for k, (n1, n2) in enumerate(sizes):
        g1 = fuzz_graph(rng, n1, E, dim=dim, max_skip=2 + 3 * (k % 4))
        g2 = fuzz_graph(rng, n2, E, dim=dim, max_skip=1 + 2 * (k % 5))
        for g in (g1, g2):     # -0.0 and values float32 rounds
            g.sites[::7, 3] = -0.0
            g.sites[::5, 4] = 1.0 / 3.0
        items.append((g1, g2, m, sc))
    return items


def _batches(preps):
    order = sorted(preps, key=lambda p: -(p.g1.size + p.g2.size))
    return [gdp.pack_pairs(order[a:b], "cpu")
            for a, b in ((0, 1), (1, 4), (4, len(order)), (0, len(order)))]


@pytest.mark.parametrize("threads", ["1", "4"])
@pytest.mark.parametrize("shape", ["mixed", "large"])
def test_pack_with_and_without_the_library(monkeypatch, threads, shape):
    """pack_pairs' Batch with the library and with native.lib returning
    None: every tensor bit for bit, plan, Rmax, Lm; launches of one pair,
    a few and all, of mixed sizes and slot counts ("large": enough plane
    entries for four threads)."""
    monkeypatch.setenv("PROGRAPHMSA_THREADS", threads)
    rng = np.random.default_rng(7 if shape == "mixed" else 8)
    sizes = ([(int(rng.integers(2, 90)), int(rng.integers(2, 90)))
              for _ in range(9)] if shape == "mixed"
             else [(1400 + 9 * k, 1300 - 7 * k) for k in range(7)])
    items = _prep_items(rng, sizes, 4 if shape == "mixed" else 3)
    preps = [gdp.prep_pair(k, *it) for k, it in enumerate(items)]
    assert all(not isinstance(p, str) for p in preps)
    assert len({len(p.o1) for p in preps} | {len(p.o2) for p in preps}) > 2
    got = _batches(preps)
    with dp_prep_time.numpy_bodies():
        want = _batches(preps)
        assert dp_prep_time.same_preps(
            preps, [gdp.prep_pair(k, *it) for k, it in enumerate(items)])
    assert dp_prep_time.same_batches(got, want)
    if shape == "large":
        bt = got[-1]
        entries = (len(bt.n1) * (bt.g1T.shape[1] + 2 * bt.C1T.shape[1])
                   * (bt.C1T.shape[2] + bt.C2T.shape[2]))
        assert entries >> 18 >= 4


def test_pack_planes_checks_shapes_and_converts_types():
    rng = np.random.default_rng(3)
    p = gdp.prep_pair(0, *_prep_items(rng, [(30, 20)], 3)[0])
    arrays = [(p.g1.sites, p.g2.sites, p.C1, p.C2, p.rep1, p.rep2)]
    for dims in ((20, 24, 24, 8), (20, 32, 16, 8), (20, 32, 24, 1),
                 (19, 32, 24, 8)):
        with pytest.raises(ValueError, match="do not fit"):
            native.pack_planes_native(arrays, *dims, slots.COST_INF)
    # other types cross converted: float32 sites, float64 costs, uint8
    # flags, a strided C
    other = [(p.g1.sites.astype(np.float32), p.g2.sites,
              np.asfortranarray(p.C1).astype(np.float64), p.C2,
              p.rep1.astype(np.uint8), p.rep2)]
    got = native.pack_planes_native(other, 20, 32, 24, 8, slots.COST_INF)
    want = native.pack_planes_native(arrays, 20, 32, 24, 8, slots.COST_INF)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


# ---------------------------------------------------------------------------
# which body runs


def _small_items():
    m = checks.model(0.5)
    rng = np.random.RandomState(3)
    pairs = [(checks.merged("ACDEFGHIKLMNPQRSTVWY", "ACDEFGIKMNPQRSTVWY", m),
              checks.chain("ACDEFGHIKLMNPQRSTVW"), m)]
    pairs += [(checks.heavy(30, [2, 3], 1), checks.heavy(26, [2, 4], 2), m)]
    pairs += [(checks.chain(checks.random_seq(rng, 40)),
               checks.chain(checks.random_seq(rng, 33)), m)]
    return checks.items_and_expected(pairs)


@pytest.mark.parametrize("library", ["on", "off"])
def test_spies_on_the_path_taken(monkeypatch, library):
    """align_pairs_device takes the native tables and planes where the
    library loads and the numpy bodies where native.lib gives None, with
    the same results."""
    items, expected = _small_items()
    if library == "off":
        monkeypatch.setattr(native, "lib", lambda: None)
    calls = {"tables": 0, "planes": 0, "tables_numpy": 0, "planes_numpy": 0}

    def spy(key, fn):
        def wrapped(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(native, "offset_costs_native",
                        spy("tables", native.offset_costs_native))
    monkeypatch.setattr(native, "pack_planes_native",
                        spy("planes", native.pack_planes_native))
    monkeypatch.setattr(slots, "_offset_costs_rep_numpy",
                        spy("tables_numpy", slots._offset_costs_rep_numpy))
    monkeypatch.setattr(gdp, "_planes_numpy",
                        spy("planes_numpy", gdp._planes_numpy))
    res = gdp.align_pairs_device(items, "cpu")
    for r, aln in zip(res, expected):
        assert checks.same_alignment(r, aln)
    on, off = ("tables", "planes"), ("tables_numpy", "planes_numpy")
    if library == "off":
        on, off = off, on
    assert calls[on[0]] == 2 * len(items) and calls[on[1]] >= 1
    assert calls[off[0]] == calls[off[1]] == 0


@pytest.mark.parametrize("which", ["tables", "planes"])
def test_a_failing_library_raises_and_is_not_retried(monkeypatch, which):
    items, _ = _small_items()

    def broken(*a, **kw):
        raise RuntimeError("native %s failed" % which)

    monkeypatch.setattr(native, {"tables": "offset_costs_native",
                                 "planes": "pack_planes_native"}[which],
                        broken)
    monkeypatch.setattr(slots, "_offset_costs_rep_numpy",
                        lambda *a: pytest.fail("retried in numpy"))
    monkeypatch.setattr(gdp, "_planes_numpy",
                        lambda *a: pytest.fail("retried in numpy"))
    with pytest.raises(RuntimeError, match="native %s failed" % which):
        gdp.align_pairs_device(items, "cpu")


def test_slot_tables_check_the_padded_shapes():
    idx, cost, isrep, units = fuzz_graph(np.random.default_rng(2), 9,
                                         3).padded()
    for bad in ((idx, cost[:, :2], isrep, units), (idx[0], cost[0],
                                                   isrep[0], units[0])):
        with pytest.raises(ValueError, match="padded arrays"):
            native.offset_costs_native(bad, np.float32(1), np.float32(1),
                                       slots.MAX_OFF)


def test_a_disagreeing_slot_count_raises(monkeypatch):
    """A library whose second call finds another number of slots than its
    first is an error."""
    real = native.lib()

    class Disagreeing:
        def __getattr__(self, name):
            return getattr(real, name)

        @staticmethod
        def gc_offset_costs(*a):
            return real.gc_offset_costs(*a) + 1

    monkeypatch.setattr(native, "lib", lambda: Disagreeing())
    g = fuzz_graph(np.random.default_rng(1), 20, 3)
    with pytest.raises(RuntimeError, match="gc_offset_costs found"):
        slots.offset_costs_rep(g, _scores(), slots.MAX_OFF)
