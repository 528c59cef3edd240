"""Pairs past the JAX package's TPU tiers on the port's device batch: more
than 64 offset slots a side (8-bit code fields, int64 code words) and
reaches past 256 ring diagonals.  The JAX package's batch refuses them
(``fb_offsets``, ``fb_reach``) and aligns them on its host; the port's
batch takes them (up to slots.MAX_OFF = 255 slots a side, any reach its
launch holds), and on the CPU its plain versions of K3 and X1 give the
host's mappings, float32 score bits and n_tr_indels, with no tolerance.
The kernels themselves are held against these plain versions on the card
(chip_smoke.py, phase ``fill_chase``).
"""

import numpy as np
import pytest
import torch

from prographmsa_tpu.align import dp as ref_dp
from prographmsa_tpu.align import graph_dp_pallas as ref_gdp
from prographmsa_tpu.align import scores as ref_scores
from prographmsa_tpu.align.backtrack import backtrack as ref_backtrack

from prographmsa_tpu_torch import checks
from prographmsa_tpu_torch.align import graph_dp_cuda as gdp
from prographmsa_tpu_torch.align import slots
from prographmsa_tpu_torch.align.chase_cuda import (META_LEN, META_SCORE,
                                                    N_META, chase_torch,
                                                    plan_chase)
from prographmsa_tpu_torch.align.fill_cuda import code_dtype, fill_torch
from prographmsa_tpu_torch.align.scores_cuda import exact_s
from prographmsa_tpu_torch.align.slots import MAX_OFF, NARROW_OFF, NEG


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The plain versions' tensors on one intra-op thread: the suite's
    workers share the cores, and torch's default pool of a thread a core
    in each of them makes these cases 30-70 times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_host(g1, g2, m, sc):
    """The JAX package's host DP: numpy S, fill_dp and backtrack."""
    S = ref_scores.precompute_scores(g1, g2, m, sc, engine="numpy")
    return ref_backtrack(g1, g2, ref_dp.fill_dp(g1, g2, S, sc), sc)


def _same(res, aln):
    return (res is not None and list(res[0]) == list(aln.mapping1)
            and list(res[1]) == list(aln.mapping2)
            and np.float32(res[2]).tobytes() == np.float32(aln.score).tobytes()
            and res[3] == aln.n_tr_indels)


def _held(pairs, opts=checks.OPTS, refused_by_jax=None):
    """The port's batch on the CPU against the JAX package's host DP, pair
    by pair, every pair on the device path; with ``refused_by_jax`` the
    JAX package's own batch counts every pair under that reason and
    returns None for it.  Returns (items, port results)."""
    items, _ = checks.items_and_expected(pairs, opts)
    before = gdp.fallback_stats()
    res = gdp.align_pairs_device(items, "cpu")
    after = gdp.fallback_stats()
    assert after["pairs_device"] - before["pairs_device"] == len(items)
    for k, (r, it) in enumerate(zip(res, items)):
        assert _same(r, _jax_host(*it)), k
    if refused_by_jax is not None:
        ref_before = ref_gdp.fallback_stats()
        assert ref_gdp.align_pairs_device(items, interpret=True) == \
            [None] * len(items)
        ref_after = ref_gdp.fallback_stats()
        assert (ref_after[refused_by_jax] - ref_before[refused_by_jax]
                == len(items))
    return items, res


def _prep(pair, opts=checks.OPTS):
    return gdp.prep_pair(0, *pair, checks.DynProgScores(*pair, opts))


def _short_chain(seed, n=20):
    return checks.chain(checks.random_seq(np.random.RandomState(seed), n))


@pytest.mark.parametrize("slots", [65, 128, 200, 255])
def test_one_side_past_64_slots(slots):
    """One side of ``slots`` offset slots against a short chain: 8-bit code
    fields, int64 code words, the host's alignment; the JAX package
    counts it fb_offsets."""
    pair = (checks.many_offsets_graph(slots + 40, slots - 1, slots),
            _short_chain(slots), checks.model(0.5))
    p = _prep(pair)
    assert len(p.o1) == slots and len(p.o2) == 1 and p.shb == 8
    _held([pair], refused_by_jax="fb_offsets")


def test_both_sides_past_64_slots():
    pair = (checks.many_offsets_graph(90, 70, 4),
            checks.many_offsets_graph(85, 68, 5), checks.model(0.5))
    p = _prep(pair)
    assert min(len(p.o1), len(p.o2)) > NARROW_OFF and p.shb == 8
    _held([pair], refused_by_jax="fb_offsets")


def test_reach_past_256_diagonals():
    """One skip edge of offset 300: rings of 305 diagonals with narrow
    codes, which the launch's size rule now counts; the JAX package counts
    the pair fb_reach."""
    pair = (checks.heavy(340, [2, 300], 6), checks.heavy(60, [2, 3], 7),
            checks.model(0.5))
    p = _prep(pair)
    assert p.R == 305 and p.shb == 4
    _held([pair], refused_by_jax="fb_reach")
    assert gdp.launch_fits(1, 340, 60, 20, 3, 305)


def test_repeat_event_through_a_slot_past_64():
    """The walk takes a repeat slot of index 64 or more (X1's repeat flags
    past its 64-bit masks): the event is spliced as the host splices it;
    the numpy model of X1's walk (flags per node, the window) gives
    chase_torch's rows."""
    pair = checks.wide_repeat_pair()
    p = _prep(pair, checks.REPEAT_OPTS)
    k = list(p.o1).index(71)
    assert len(p.o1) > NARROW_OFF and k >= 64 and p.rep1[:, k].any()
    items, res = _held([pair], checks.REPEAT_OPTS,
                       refused_by_jax="fb_offsets")
    assert res[0][3] > 0
    bt = gdp.pack_pairs([gdp.prep_pair(0, *items[0])], "cpu")
    Sd = exact_s(bt.g1T, bt.g2T, bt.M, bt.pi, bt.mi, bt.n1, bt.n2)
    fo = fill_torch(Sd, bt.O1, bt.O2, bt.C1T, bt.C2T, bt.iv, bt.par, bt.Rmax)
    args = (bt.O1, bt.O2, bt.C1T, bt.C2T, bt.R1T, bt.R2T, bt.iv, bt.par,
            bt.Lm)
    want = chase_torch(fo, *args).numpy()
    for win in (8, 32):
        assert np.array_equal(checks.chase_window_model(fo, *args,
                                                        win=win)[0], want)


def test_mixed_batch_cuts_launches_by_width():
    """Narrow and wide pairs in one batch: the wide pairs go first, in
    launches of their own (int64 code words, counted in WIDE_KEYS), the
    narrow ones as before; every result is the host's."""
    m = checks.model(0.5)
    rng = np.random.RandomState(8)
    narrow = [(checks.heavy(60, [2, 3, 5, 7], 1),
               checks.heavy(55, [2, 3, 4], 2), m),
              (checks.chain(checks.random_seq(rng, 30)),
               checks.chain(checks.random_seq(rng, 26)), m)]
    wide = [(checks.many_offsets_graph(110, 70, 9), _short_chain(3), m),
            (checks.many_offsets_graph(100, 80, 10), _short_chain(4, 12),
             m)]
    pairs = [narrow[0], wide[0], narrow[1], wide[1]]
    before = gdp.fallback_stats()
    items, _ = _held(pairs)
    after = gdp.fallback_stats()
    assert [after[k] - before[k] for k in gdp.WIDE_KEYS] == [1, 2]
    preps = [gdp.prep_pair(k, *it) for k, it in enumerate(items)]
    cuts = gdp._launches(preps)
    widths = [{slots.wide(gdp.slots_of(p)) for p in c} for c in cuts]
    assert widths == [{True}, {False}]
    assert [sorted(p.idx for p in c) for c in cuts] == [[1, 3], [0, 2]]
    bts = [gdp.pack_pairs(c, "cpu") for c in cuts]
    assert [code_dtype(bt.O1.shape[1]) for bt in bts] == [torch.int64,
                                                          torch.int32]
    assert [set(bt.iv[:, 5].tolist()) for bt in bts] == [{8}, {4}]


def _fill_args(bt):
    Sd = exact_s(bt.g1T, bt.g2T, bt.M, bt.pi, bt.mi, bt.n1, bt.n2)
    return Sd, bt.O1, bt.O2, bt.C1T, bt.C2T, bt.iv, bt.par, bt.Rmax


def test_256_slots_still_fb_offsets():
    pair = (checks.many_offsets_graph(300, 255, 11), _short_chain(12),
            checks.model(0.5))
    assert _prep(pair) == "fb_offsets"
    items, _ = checks.items_and_expected([pair])
    before = gdp.fallback_stats()
    assert gdp.align_pairs_device(items, "cpu") == [None]
    after = gdp.fallback_stats()
    assert after["fb_offsets"] == before["fb_offsets"] + 1
    assert after["pairs_device"] == before["pairs_device"]


def test_fill_and_chase_plain_versions_against_the_host_on_a_wide_pair():
    """fill_torch's final rings on a pair of 8-bit code fields and a reach
    past 256 against the JAX package's fill_dp matrices, cell by cell
    where the host value is real; chase_torch's row against its
    backtrack: the mapping, the score's bits."""
    g1 = checks.heavy(330, list(range(2, 90)) + [290], 13)
    g2 = checks.heavy(50, [2, 3], 14)
    m = checks.model(0.5)
    sc = checks.DynProgScores(g1, g2, m, checks.OPTS)
    p = gdp.prep_pair(0, g1, g2, m, sc)
    assert len(p.o1) > NARROW_OFF and p.R > 256 and p.shb == 8
    bt = gdp.pack_pairs([p], "cpu")
    fa = _fill_args(bt)
    fo = fill_torch(*fa)
    assert fo.codes.dtype == code_dtype(len(p.o1)) == torch.int64
    assert int(fo.codes.max()) >= 1 << 32    # a W-state past 32 bits
    S = ref_scores.precompute_scores(g1, g2, m, sc, engine="numpy")
    host = ref_dp.fill_dp(g1, g2, S, sc)
    n1, n2, R = g1.size, g2.size, p.R
    dfull = n1 + n2 - 2
    n_cells = 0
    for name, ring in (("W", fo.ringW), ("Y", fo.ringY), ("X", fo.ringX),
                       ("M", fo.ringM)):
        H = getattr(host, name)
        for d in range(max(2, dfull - R + 1), dfull - 1):
            for y in range(max(1, d - (n2 - 2)), min(n1 - 2, d - 1) + 1):
                h = H[y, d - y]
                if np.isfinite(h) and h > NEG:
                    v = ring[0, d % R, y].numpy()
                    assert v.tobytes() == np.float32(h).tobytes(), \
                        (name, y, d - y)
                    n_cells += 1
    assert n_cells > 1000
    aln = ref_backtrack(g1, g2, host, sc)
    Lm = bt.Lm
    row = chase_torch(fo, bt.O1, bt.O2, bt.C1T, bt.C2T, bt.R1T, bt.R2T,
                      bt.iv, bt.par, Lm)[0].numpy()
    ln = int(row[2 * Lm + META_LEN])
    assert list(row[:ln][::-1]) == list(aln.mapping1)
    assert list(row[Lm:Lm + ln][::-1]) == list(aln.mapping2)
    assert row[2 * Lm + META_SCORE:][:1].view(np.float32)[0].tobytes() == \
        np.float32(aln.score).tobytes()
    assert N_META == 4


def test_wide_launch_sizes_follow_the_code_width_and_reach():
    """launch_fits counts 8 bytes a code position past NARROW_OFF slots,
    K3's four ring planes past NEAR_R diagonals and X1's shared memory of
    the wide layout (one byte of repeat flags a node); the narrow rule is
    as it was."""
    side = 8192                  # (8192 + 8190) * 8192 * 8 bytes: just fits
    assert gdp.launch_fits(1, side, side - 2, 20)
    assert gdp.launch_fits(1, side, side - 2, 20, NARROW_OFF, gdp.NEAR_R)
    assert not gdp.launch_fits(1, side, side - 2, 20, NARROW_OFF + 1)
    assert not gdp.launch_fits(1, side, side - 2, 20, 1, gdp.NEAR_R + 1)
    assert gdp.launch_fits(1, 5897, 910, 20, 156, 415)    # the census's
    assert gdp.launch_fits(1, 5388, 1944, 20, 193, 1502)  # largest pairs
    # X1 past 27,512 columns: the narrow masks do not fit, the wide bytes do
    assert not gdp.launch_fits(1, 8, 27513, 20)
    assert gdp.launch_fits(1, 8, 27513, 20, MAX_OFF)
    assert (plan_chase(1, MAX_OFF, 8, 27513).smem_bytes
            == 8 * 32 * 32 + 4 * (2 * 256 + 4 * 32) + 8 + 27513)
    with pytest.raises(ValueError):
        plan_chase(1, MAX_OFF + 1, 8, 10)
