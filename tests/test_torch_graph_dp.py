"""The port's device graph-pair DP batch (prographmsa_tpu_torch/align/
graph_dp_cuda.py: exact S, wavefront fill, code chase, harvest) vs the
reference's host fill_dp + backtrack, and on a few small pairs vs the
reference's own batch (graph_dp_pallas.align_pairs_device in interpret
mode).  Cases mirror tests/test_graph_dp_pallas.py.

On the CPU the batch runs the kernels' plain PyTorch versions; the CUDA
kernels are held against those on the card (the ``cuda`` test here, and
chip_smoke.py).  Compared: mappings, float32 score and n_tr_indels, with no
tolerance.  Decision-code planes are never compared with the reference's:
codes in cells no path reaches depend on how many padded slots a kernel
visits.
"""

import numpy as np
import pytest
import torch

from prographmsa_tpu.align import graph_dp_pallas as ref_gdp

from prographmsa_tpu_torch import checks
from prographmsa_tpu_torch.align import graph_dp_cuda as gdp
from prographmsa_tpu_torch.align.chase_cuda import (
    MAX_WARPS, MAX_WINDOW, META_FAIL_CHASE, META_FAIL_REP, META_LEN, N_META,
    N_STATS, chase, chase_torch, plan_chase, row_width)
from prographmsa_tpu_torch.align.fill_cuda import (
    LANE_THREADS, MAX_BLOCKS_PER_PAIR, MAX_THREADS, SMEM_BYTES, SMS,
    WIDE_BLOCKS_PER_PAIR, card_limits, fill, fill_torch, plan_fill)
from prographmsa_tpu_torch.align.slots import (BIG, EV_CAP, FLOOR, MAX_OFF,
                                               NARROW_OFF)
from prographmsa_tpu_torch.align.scores_cuda import exact_s


def _assert_batch(pairs, opts=checks.OPTS, device="cpu"):
    items, expected = checks.items_and_expected(pairs, opts)
    before = gdp.fallback_stats()
    res = gdp.align_pairs_device(items, device)
    after = gdp.fallback_stats()
    for k, (r, aln) in enumerate(zip(res, expected)):
        assert checks.same_alignment(r, aln), k
    assert after["pairs_device"] - before["pairs_device"] == len(items)
    for k in gdp.FALLBACK_KEYS:
        if k.startswith("fb_"):
            assert after[k] == before[k], k
    return res, expected


def test_chains():
    m = checks.model(0.3)
    _assert_batch([(checks.chain("ACDEFGHIKLMNP"),
                    checks.chain("ACDEFGIKLMNP"), m)])


def test_merged_graphs_both_orders():
    m = checks.model(0.3)
    cg = checks.merged("ACDEFGHIKLMNPQRSTVWY", "ACDEFGIKMNPQRSTVWY", m)
    g3 = checks.chain("ACDEFGHIKLMNPQRSTVW")
    _assert_batch([(cg, g3, m), (g3, cg, m)])


def test_merged_vs_merged():
    m = checks.model(0.3)
    cg = checks.merged("ACDEFGHIKLMNPQRSTVWY", "ACDEFGIKMNPQRSTVWY", m)
    g3 = checks.chain("ACDEFGHIKLMNPQRSTVW")
    aln, _ = checks.host_align(cg, g3, m)
    anc = checks.merge_graphs(cg, g3, aln.mapping1, aln.mapping2, m, m, 0.5,
                              0.5, checks.OPTS)
    cg2 = checks.clean_graph(anc.graph, checks.OPTS)[0]
    _assert_batch([(cg2, cg, checks.model(0.8))])


def test_random_pairs():
    rng = np.random.RandomState(5)
    m = checks.model(0.6)
    _assert_batch([(checks.chain(checks.random_seq(rng, rng.randint(8, 80))),
                    checks.chain(checks.random_seq(rng, rng.randint(8, 80))),
                    m) for _ in range(4)])


def test_asymmetric_long_g2():
    """n2 >> n1: the walk runs along the y == 0 boundary far past n1, so
    the X stripe must span n2."""
    pairs = []
    for seed in (0, 1, 2):
        rng = np.random.RandomState(seed)
        m = checks.model(0.3)
        s = checks.random_seq(rng, 190)
        cg2 = checks.merged(s, checks.mutated(rng, s, 12), m)
        assert cg2.size > 130
        pairs.append((checks.chain(checks.random_seq(rng, 13)), cg2, m))
    _assert_batch(pairs)


def test_repeat_edges_splice():
    res, expected = _assert_batch([checks.fixed_repeat_pair()],
                                  checks.REPEAT_OPTS)
    assert expected[0].n_tr_indels > 0, "fixture must take a repeat edge"


def test_repeat_fuzz():
    res, expected = _assert_batch([checks.repeat_pair(s) for s in range(4)],
                                  checks.REPEAT_OPTS)
    assert sum(a.n_tr_indels for a in expected) > 0


def test_mixed_batch_stays_on_device():
    rng = np.random.RandomState(9)
    m = checks.model(0.4)
    cg = checks.merged("ACDEFGHIKLMNPQRSTVWY", "ACDEFGIKMNPQRSTVWY", m)
    _assert_batch([
        (checks.chain("ACDEFGHIKLMNP"), checks.chain("ACDEFGIKLMNP"), m),
        (cg, checks.chain("ACDEFGHIKLMNPQRSTVW"), m),
        (checks.chain(checks.random_seq(rng, 40)),
         checks.chain(checks.random_seq(rng, 33)), m)])


def test_many_offsets():
    m = checks.model(0.5)
    _assert_batch([
        (checks.heavy(60, [2, 3, 5, 7, 11, 13, 17], 1),
         checks.heavy(55, [2, 3, 4, 6, 9], 2), m),
        (checks.heavy(48, [2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 19, 23],
                      3),
         checks.heavy(52, [2, 3, 5, 8, 13, 21, 34, 55], 4), m)])


def test_more_than_16_offsets_wide_codes():
    """More than 16 slots: 6-bit code fields (the reference's op >= 32
    single-pair tiers, which its own fuzz never reaches)."""
    rng = np.random.RandomState(21)
    pair = (checks.many_offsets_graph(40, 18, 5),
            checks.chain(checks.random_seq(rng, 30)), checks.model(0.5))
    p = gdp.prep_pair(0, *pair, checks.DynProgScores(*pair, checks.OPTS))
    assert len(p.o1) > 16 and p.shb == 6
    _assert_batch([pair])


def test_against_reference_batch_interpret_mode():
    """A chain pair, a merged pair and a repeat pair through the reference's
    own device batch (Pallas fill in interpret mode, host S) and the port:
    identical mappings, scores, n_tr_indels and fallback counters."""
    m = checks.model(0.3)
    cg = checks.merged("ACDEFGHIKLMNPQRSTVWY", "ACDEFGIKMNPQRSTVWY", m)
    items, _ = checks.items_and_expected([
        (checks.chain("ACDEFGHIKLMNP"), checks.chain("ACDEFGIKLMNP"), m),
        (cg, checks.chain("ACDEFGHIKLMNPQRSTVW"), m)])
    g1 = checks.chain("ACDEF" + "GH" * 2 + "KLMN")
    tr = np.full(g1.size, -1, dtype=np.int64)
    tr[6:10] = np.tile(np.arange(2), 2)
    g1.add_repeats([tr])
    rep_items, _ = checks.items_and_expected(
        [(g1, checks.chain("ACDEFGHKLMN"),
          checks.model(0.3, checks.REPEAT_OPTS))], checks.REPEAT_OPTS)
    items += rep_items
    ref_before = ref_gdp.fallback_stats()
    ref = ref_gdp.align_pairs_device(items, interpret=True)
    ref_after = ref_gdp.fallback_stats()
    before = gdp.fallback_stats()
    ours = gdp.align_pairs_device(items, "cpu")
    after = gdp.fallback_stats()
    for r, o in zip(ref, ours):
        assert r is not None and o is not None
        assert list(o[0]) == list(r[0]) and list(o[1]) == list(r[1])
        assert np.float32(o[2]) == np.float32(r[2]) and o[3] == r[3]
    assert ours[2][3] > 0, "the repeat pair must splice an event"
    for k in gdp.FALLBACK_KEYS:
        assert (after[k] - before[k]) == (ref_after[k] - ref_before[k]), k


def _chain_of(n, rng):
    return checks.chain(checks.random_seq(rng, n - 2))


def test_fallback_reasons_match_reference():
    """Pairs the batch refuses, and why, beside the reference's prep: a
    pair past every launch (the same reason), 256 offset slots on a side
    (the same), rings whose planes overflow the launch (the port's
    fb_reach; the reference's cap of 4,096 nodes a side calls it fb_size).
    The reference also refuses more than 64 slots a side and rings past
    256 diagonals (its TPU's tiers) and a side over 4,096 nodes (MAX_N,
    its TPU plane budget); the port takes such pairs where its kernels
    hold them (launch_fits), and the plain twins' mapping, score and
    n_tr_indels equal the host's."""
    rng = np.random.RandomState(3)
    m = checks.model(0.3)
    small = _chain_of(20, rng)
    side = 8200           # (2 * 8200) * 8200 * 8 bytes > LAUNCH_BYTES
    # the port's reason: (pair, the reference's reason); an 8,000-row pair
    # with a skip of 5,000: its planes fit, its four ring planes of 5,003
    # diagonals do not
    cases = {
        "fb_size": ((_chain_of(side, rng), _chain_of(side, rng)),
                    "fb_size"),
        "fb_offsets": ((checks.many_offsets_graph(300, 255, 1), small),
                       "fb_offsets"),
        "fb_reach": ((checks.heavy(8000, [5000], 4), small), "fb_size"),
    }
    for reason, ((g1, g2), ref_reason) in cases.items():
        sc = checks.DynProgScores(g1, g2, m, checks.OPTS)
        assert ref_gdp._prep_pair(0, g1, g2, m, sc) == ref_reason
        assert gdp.prep_pair(0, g1, g2, m, sc) == reason
        before = gdp.fallback_stats()
        assert gdp.align_pairs_device([(g1, g2, m, sc)], "cpu") == [None]
        after = gdp.fallback_stats()
        assert after[reason] == before[reason] + 1
        assert after["pairs_device"] == before["pairs_device"]
    # past the reference's tiers: 71 slots on a side, a reach of 502
    for ref_reason, pair in (
            ("fb_offsets", (checks.many_offsets_graph(80, 70, 1), small, m)),
            ("fb_reach", (checks.heavy(270, [250], 2),
                          checks.heavy(270, [250], 3), m))):
        items, _ = checks.items_and_expected([pair])
        assert ref_gdp._prep_pair(0, *items[0]) == ref_reason
        _assert_batch([pair])
    # one side past the reference's cap: rows of a chain of 3 nodes, so
    # the plain fill's diagonals stay short, and edges of offset 64 that
    # the walk takes, so the plain chase's steps do too
    pair = (_chain_of(3, rng), checks.heavy(ref_gdp.MAX_N + 1, [64], 5), m)
    items, expected = checks.items_and_expected([pair])
    assert ref_gdp._prep_pair(0, *items[0]) == "fb_size"
    res, _ = _assert_batch([pair])
    assert len(expected[0].mapping1) < 300


class _Side:
    """What ``_launches`` reads of a graph: its size and width."""

    def __init__(self, size, dim=20):
        self.size, self.dim = size, dim


def _sized(sizes):
    """Preps of pairs of chains (one slot a side, rings of 4 diagonals)."""
    one = np.ones(1, np.int32)
    return [gdp.PairPrep(k, _Side(a), _Side(b), None, None, one, None, None,
                         one, None, None, 4, 4)
            for k, (a, b) in enumerate(sizes)]


# (B, n1, n2, dim), whether one launch holds it, and the limit at stake
LAUNCH_CASES = [
    ((1, 865, 5767, 20), True, "the 2,000 run's largest pair"),
    ((1, 8192, 8190, 20), True, "planes just within LAUNCH_BYTES"),
    ((1, 8192, 8193, 20), False, "planes past LAUNCH_BYTES"),
    ((1, 8, 27512, 20), True, "X1's shared memory just holds"),
    ((1, 8, 27513, 20), False, "X1's shared memory"),
    ((65535, 3, 3, 20), True, "K2's grid just holds"),
    ((65536, 3, 3, 20), False, "K2's grid of pairs"),
    ((1, 30, 30, 65), False, "K1's and K2's widths"),
]


@pytest.mark.parametrize("shape,fits,why", LAUNCH_CASES,
                         ids=[c[2] for c in LAUNCH_CASES])
def test_launch_fits_follows_the_kernels_plans(shape, fits, why):
    """The size rule is the kernels' own limits: LAUNCH_BYTES, X1's shared
    memory (plan_chase), K2's grid and the widths K1 and K2 take; the
    reference's cap of 4,096 nodes a side is not one of them."""
    B, n1, n2, dim = shape
    assert gdp.launch_fits(B, n1, n2, dim) is fits
    n1max = -(-n1 // 8) * 8
    if why.startswith("X1"):
        assert (plan_chase(B, NARROW_OFF, n1max, n2).smem_bytes
                <= SMEM_BYTES) is fits
    assert (B * (n1 + n2) * n1 * 8 <= gdp.LAUNCH_BYTES) is (
        fits or not why.startswith("planes"))


def test_launches_cut_where_a_kernel_would_not_hold_the_launch():
    """Two pairs whose planes fit one launch together but whose padded
    shape X1's shared memory does not hold go to two launches; pairs go
    on sharing a launch up to K2's grid; a pair past every launch never
    reaches the cut."""
    assert [len(c) for c in gdp._launches(_sized([(1000, 10),
                                                   (10, 26600)]))] == [1, 1]
    assert [len(c) for c in gdp._launches(_sized([(1000, 10),
                                                   (10, 20000)]))] == [2]
    assert [len(c) for c in gdp._launches(
        _sized([(3, 3)] * 65537))] == [65535, 2]
    with pytest.raises(AssertionError):
        gdp._launches(_sized([(8192, 8193)]))


def test_harvest_counts_rep_overflow_and_chase_failure_apart():
    """The reference counts every chase failure as fb_rep; the port keeps
    fb_rep (more than EV_CAP repeat events) and fb_chase apart."""
    Lm = 6
    packed = np.zeros((2, row_width(Lm)), np.int32)
    packed[0, 2 * Lm + META_FAIL_REP] = 1
    packed[1, 2 * Lm + META_FAIL_CHASE] = 1
    assert N_META == 4
    chunk = [gdp.PairPrep(k, *([None] * 12)) for k in range(2)]
    before = gdp.fallback_stats()
    results = [0, 0]
    gdp._harvest(chunk, packed, Lm, results)
    after = gdp.fallback_stats()
    assert results == [0, 0]
    assert after["fb_rep"] == before["fb_rep"] + 1
    assert after["fb_chase"] == before["fb_chase"] + 1
    assert after["pairs_device"] == before["pairs_device"]


def test_wrappers_take_plain_versions_on_cpu():
    m = checks.model(0.5)
    items, _ = checks.items_and_expected(
        [(checks.heavy(30, [2, 3], 1), checks.heavy(26, [2, 4], 2), m)])
    bt = gdp.pack_pairs([gdp.prep_pair(0, *items[0])], "cpu")
    Sd = exact_s(bt.g1T, bt.g2T, bt.M, bt.pi, bt.mi, bt.n1, bt.n2)
    fa = (Sd, bt.O1, bt.O2, bt.C1T, bt.C2T, bt.iv, bt.par, bt.Rmax)
    fo, fp = fill(*fa), fill_torch(*fa)
    for a, b in zip(fo, fp):
        assert torch.equal(a, b)
    ca = (bt.O1, bt.O2, bt.C1T, bt.C2T, bt.R1T, bt.R2T, bt.iv, bt.par, bt.Lm)
    assert torch.equal(chase(fo, *ca), chase_torch(fp, *ca))


def _ref_batch_equal(items):
    """The JAX package's own batch (Pallas fill in interpret mode) and the
    port's on the same pairs: mappings, score, n_tr_indels."""
    ref = ref_gdp.align_pairs_device(items, interpret=True)
    ours = gdp.align_pairs_device(items, "cpu")
    for r, o in zip(ref, ours):
        assert r is not None and o is not None
        assert list(o[0]) == list(r[0]) and list(o[1]) == list(r[1])
        assert np.float32(o[2]) == np.float32(r[2]) and o[3] == r[3]
    return ours


def test_mostly_edgeless_slots_one_pair_batch():
    """A one-pair batch whose slots are mostly edge-less (more than 16
    offsets, each node with a few of them): only the slots with an edge are
    candidates; the result equals the JAX package's batch, the host and the
    port's native tier."""
    g1 = checks.many_offsets_graph(44, 20, 7)
    g2 = checks.heavy(40, [2, 3, 5, 9, 14], 8)
    pair = (g1, g2, checks.model(0.5))
    p = gdp.prep_pair(0, *pair, checks.DynProgScores(*pair, checks.OPTS))
    assert len(p.o1) > 16
    edges = np.count_nonzero(p.C1 < gdp.COST_INF)
    assert edges < 0.25 * p.C1.size, "slots must be mostly edge-less"
    res, expected = _assert_batch([pair])
    items, _ = checks.items_and_expected([pair])
    ours = _ref_batch_equal(items)
    assert checks.same_alignment(ours[0], expected[0])
    nat = checks.native_align(*items[0])
    assert nat is not None and checks.same_alignment(ours[0], nat)


def test_merged_pair_alone_in_its_batch_matches_reference_and_native():
    m = checks.model(0.3)
    rng = np.random.RandomState(33)
    s = checks.random_seq(rng, 60)
    cg = checks.merged(s, checks.mutated(rng, s, 6), m)
    cg2 = checks.merged(s, checks.mutated(rng, s, 9), m)
    items, expected = checks.items_and_expected([(cg, cg2, m)])
    ours = _ref_batch_equal(items)
    assert checks.same_alignment(ours[0], expected[0])
    assert checks.same_alignment(ours[0], checks.native_align(*items[0]))


def _sequential_first_max(cand):
    """The rule K3 implements per cell: strict improvement from FLOOR in
    visit order; (value, winning visit index or -1)."""
    acc, at = float(FLOOR), -1
    for k, c in enumerate(cand.tolist()):
        if c > acc:
            acc, at = c, k
    return acc, at


def _lanes_first_max(cand, lanes):
    """The same rule as K3 runs it on ``lanes`` threads: each lane scans the
    candidates k = lane, lane + lanes, ... in order, then a butterfly keeps
    the larger value and, at equal values, the smaller visit index."""
    none = 1 << 30
    val = torch.full((lanes,), float(FLOOR), dtype=torch.float32)
    idx = torch.full((lanes,), none, dtype=torch.long)
    for k, c in enumerate(cand):
        lane = k % lanes
        if bool(c > val[lane]):
            val[lane], idx[lane] = c, k
    off = lanes // 2
    while off:
        peer = torch.arange(lanes) ^ off
        ov, oi = val[peer], idx[peer]
        take = (ov > val) | ((ov == val) & (oi < idx))
        val, idx = torch.where(take, ov, val), torch.where(take, oi, idx)
        off //= 2
    assert bool((val == val[0]).all()) and bool((idx == idx[0]).all())
    return float(val[0]), (-1 if int(idx[0]) == none else int(idx[0]))


@pytest.mark.parametrize("lanes", [1, 2, 4, 8, 32])
@pytest.mark.parametrize("case", ["random", "ties", "nans",
                                  "all_below_floor", "empty", "tie_at_top"])
def test_lane_split_first_max_equals_sequential_scan(case, lanes):
    rng = np.random.RandomState(len(case) * 37 + lanes)
    n = 0 if case == "empty" else rng.randint(1, 150)
    cand = rng.randn(n).astype(np.float32)
    if case == "ties":
        cand = rng.randint(-2, 3, n).astype(np.float32)
    if case == "nans":
        cand[rng.rand(n) < 0.4] = np.nan
    if case == "all_below_floor":
        cand[:] = np.float32(-3.2e38)
        cand[rng.rand(n) < 0.3] = FLOOR          # equal to FLOOR never wins
    if case == "tie_at_top":
        cand[rng.choice(n, min(n, 5), replace=False)] = np.float32(7.0)
    cand = torch.from_numpy(cand)
    assert _lanes_first_max(cand, lanes) == _sequential_first_max(cand)


# level shapes of the fam500 -i 0 pass and the timed shapes, as k3_sweep.py
# prints them on the card (PERF.md):
# (pairs, largest n1, ring diagonals, candidates per cell)
#     -> (blocks per pair, lanes per cell) with the portable cluster size,
#        and where the card holds 16-block clusters
PLAN_CASES = [
    ("fam500_level0", (186, 317, 4, 1.0), (1, 1), (1, 1)),
    ("fam100_largest_level", (39, 209, 4, 1.0), (1, 1), (1, 1)),
    ("fam500_level3", (45, 329, 12, 1.2), (1, 1), (1, 1)),
    ("fam500_level6", (15, 376, 16, 1.8), (4, 4), (4, 4)),
    ("fam500_level9", (5, 461, 26, 2.6), (8, 8), (16, 8)),
    ("fam500_level12_two_pairs", (2, 726, 62, 3.4), (8, 8), (16, 8)),
    ("fam500_level13_one_pair", (1, 1007, 65, 3.0), (8, 4), (16, 8)),
    ("fam500_level14_one_pair", (1, 1125, 98, 3.99), (8, 4), (16, 8)),
    ("fam500_root_one_pair", (1, 1514, 128, 4.5), (8, 4), (16, 8)),
    ("chains_8x2000", (8, 2002, 4, 1.0), (8, 1), (8, 1)),
    ("level_filling_the_card", (70, 600, 30, 4.0), (1, 1), (1, 1)),
    ("two_blocks_fit", (40, 600, 30, 4.0), (2, 2), (2, 2)),
]


@pytest.mark.parametrize("max_blocks", [MAX_BLOCKS_PER_PAIR,
                                        WIDE_BLOCKS_PER_PAIR])
@pytest.mark.parametrize("name,shape,portable,wide", PLAN_CASES,
                         ids=[c[0] for c in PLAN_CASES])
def test_plan_fill_blocks_per_pair(name, shape, portable, wide, max_blocks):
    B, n1max, Rmax, cands = shape
    plan = plan_fill(B, n1max, Rmax, cands, max_blocks=max_blocks)
    assert (plan.blocks_per_pair, plan.lanes) == (
        portable if max_blocks == MAX_BLOCKS_PER_PAIR else wide)
    assert plan.blocks_per_pair in (1, 2, 4, 8, 16)
    assert plan.blocks_per_pair <= max_blocks
    assert plan.blocks_per_pair == 1 or B * plan.blocks_per_pair <= 132
    band = -(-n1max // plan.blocks_per_pair)
    assert plan.lanes in (1, 2, 4, 8, 16, 32)
    assert 128 <= plan.threads <= MAX_THREADS and plan.threads % 32 == 0
    assert plan.lanes == 1 or band * plan.lanes <= LANE_THREADS
    assert plan.smem_bytes <= SMEM_BYTES
    ring_bytes = 3 * Rmax * band * 4
    assert plan.smem_rings == (2 * band * 4 + ring_bytes <= SMEM_BYTES)


def test_card_limits_of_a_cpu_device_are_the_portable_ones():
    assert card_limits("cpu") == (SMS, MAX_BLOCKS_PER_PAIR)


def test_plan_fill_moves_rings_to_global_memory_when_they_do_not_fit():
    plan = plan_fill(1, 4096, 256, 1.0)
    assert not plan.smem_rings and plan.smem_bytes == 2 * 512 * 4
    assert plan_fill(1, 4096, 256, 1.0, blocks_per_pair=2).blocks_per_pair == 2


def _sequential_first_min(diffs):
    """The rule X1 replays from the host argmin: the first candidate is
    taken whatever its value, then strict improvement."""
    best, at = 0.0, -1
    for k, d in enumerate(diffs.tolist()):
        if at < 0 or d < best:
            best, at = d, k
    return at


@pytest.mark.parametrize("lanes", [1, 2, 4, 8, 32])
@pytest.mark.parametrize("case", ["random", "ties", "all_big",
                                  "one_valid_last"])
def test_lane_split_first_min_equals_sequential_scan(case, lanes):
    """X1's end transition and boundary replays split their candidates over
    threads; the index they agree on is the sequential scan's."""
    rng = np.random.RandomState(len(case) * 41 + lanes)
    n = rng.randint(1, 150)
    diffs = np.abs(rng.randn(n)).astype(np.float32)
    if case == "ties":
        diffs = rng.randint(0, 3, n).astype(np.float32)
    if case == "all_big":                 # no valid candidate: the first wins
        diffs[:] = np.float32(BIG)
    if case == "one_valid_last":
        diffs[:] = np.float32(BIG)
        diffs[-1] = np.float32(0.5)
    assert checks.lanes_first_min(diffs, lanes) == _sequential_first_min(diffs)
    assert _sequential_first_min(diffs) == int(np.argmin(diffs))


# (pairs, most offset slots a side, largest n1, largest n2) of the timed shapes
# (fam100's largest level, 8 x 2000 x 1980 chains, fam500's root pair) and
# the edges of what the kernel takes
CHASE_PLAN_CASES = [
    ("fam100_largest_level", (39, 2, 209, 210), 128),
    ("chains_8x2000", (8, 1, 2002, 1982), 128),
    ("fam500_root_one_pair", (1, 43, 1514, 924), 256),
    ("one_short_pair", (1, 1, 12, 9), 128),
    ("most_slots", (1, 64, 300, 280), 256),
    ("longest_rows", (3, 20, 4096, 4096), 256),
]


def _chase_row_owners(plan, Lm, length):
    """How many threads of a pair's block store each entry of its packed
    row, as csrc/chase.cu lays the stores out: the walking warp's entries
    leave 32 at a time, lane k storing entry base + k of m1 and of m2; the
    whole block pads from ``length`` on and writes meta and events."""
    T = plan.threads
    own = np.zeros(row_width(Lm), np.int64)
    for base in range(0, length, 32):
        for lane in range(min(32, length - base)):
            own[base + lane] += 1
            own[Lm + base + lane] += 1
    for tid in range(T):
        for k in range(length + tid, Lm, T):
            own[k] += 1
            own[Lm + k] += 1
        for k in range(tid, N_META + 1 + 4 * EV_CAP, T):
            own[2 * Lm + k] += 1
    return own


@pytest.mark.parametrize("win", [8, 32, MAX_WINDOW])
@pytest.mark.parametrize("name,shape,threads", CHASE_PLAN_CASES,
                         ids=[c[0] for c in CHASE_PLAN_CASES])
def test_plan_chase_layout(name, shape, threads, win):
    B, opmax, n1max, n2max = shape
    plan = plan_chase(B, opmax, n1max, n2max, win=win)
    assert plan.blocks == B and plan.win == win
    assert plan.threads == threads
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= 32 * MAX_WARPS
    # the window, both offset tables, the mapping entries of one window's
    # steps and a 64-bit repeat mask per node
    assert plan.smem_bytes == (4 * (win * win + 2 * NARROW_OFF + 4 * win)
                               + 8 * (n1max + n2max))
    assert plan.smem_bytes <= SMEM_BYTES
    Lm = n1max + n2max + 8
    for length in sorted({1, 2, min(33, Lm), n1max + 5, Lm}):
        assert (_chase_row_owners(plan, Lm, length) == 1).all(), length
    assert plan_chase(B, opmax, n1max, n2max, threads=64).threads == 64


def test_plan_chase_refuses_what_the_kernel_does_not_take():
    for bad in (dict(opmax=MAX_OFF + 1), dict(win=0), dict(win=7),
                dict(win=MAX_WINDOW + 2), dict(threads=48),
                dict(threads=512)):
        kw = dict(B=1, opmax=4, n1max=100, n2max=90)
        kw.update(bad)
        with pytest.raises(ValueError):
            plan_chase(**kw)


def _window_case(kind):
    """(batch tensors, fill output) on the CPU for one family of pairs."""
    rng = np.random.RandomState(29)
    m = checks.model(0.5)
    opts = checks.OPTS
    if kind == "merged_large_offsets":
        pairs = [(checks.heavy(60, [2, 3, 5, 7, 11, 13, 17], 1),
                  checks.heavy(55, [2, 3, 4, 6, 9], 2), m),
                 (checks.heavy(48, [2, 3, 5, 8, 13, 21, 34], 3),
                  checks.heavy(52, [2, 3, 5, 8, 13, 21, 34], 4), m)]
    elif kind == "boundary_walk":
        s = checks.random_seq(rng, 90)
        pairs = [(checks.chain(checks.random_seq(rng, 9)),
                  checks.merged(s, checks.mutated(rng, s, 8),
                                checks.model(0.3)), checks.model(0.3)),
                 (checks.chain(checks.random_seq(rng, 70)),
                  checks.chain(checks.random_seq(rng, 7)), m)]
    else:
        pairs = [checks.repeat_pair(s) for s in range(3)]
        pairs.append(checks.fixed_repeat_pair())
        opts = checks.REPEAT_OPTS
    items, _ = checks.items_and_expected(pairs, opts)
    bt = gdp.pack_pairs([gdp.prep_pair(k, *it) for k, it in enumerate(items)],
                        "cpu")
    Sd = exact_s(bt.g1T, bt.g2T, bt.M, bt.pi, bt.mi, bt.n1, bt.n2)
    fo = fill_torch(Sd, bt.O1, bt.O2, bt.C1T, bt.C2T, bt.iv, bt.par, bt.Rmax)
    return bt, fo


_window_cases = {}


@pytest.mark.parametrize("win,lanes", [(2, 32), (4, 4), (8, 32), (32, 32),
                                       (MAX_WINDOW, 8)])
@pytest.mark.parametrize("kind", ["merged_large_offsets", "boundary_walk",
                                  "repeats", "event_overflow"])
def test_chase_window_model_walks_the_cells_of_chase_torch(kind, win, lanes):
    """The kernel's walk reads codes only through a window that ends at the
    cell it was filled at and restarts where a step leaves it, and repeat
    flags through one mask of slots per node.  A numpy model of exactly that (a read outside the window fails)
    gives chase_torch's packed rows, whatever the window and however the
    argmin replays are split over threads."""
    base = "repeats" if kind == "event_overflow" else kind
    if base not in _window_cases:
        _window_cases[base] = _window_case(base)
    bt, fo = _window_cases[base]
    R1T, R2T = bt.R1T, bt.R2T
    if kind == "event_overflow":      # every step is a repeat step
        R1T, R2T = torch.ones_like(R1T), torch.ones_like(R2T)
    args = (bt.O1, bt.O2, bt.C1T, bt.C2T, R1T, R2T, bt.iv, bt.par, bt.Lm)
    want = chase_torch(fo, *args).numpy()
    got, stats = checks.chase_window_model(fo, *args, win=win, lanes=lanes)
    assert np.array_equal(got, want)
    meta = want[:, 2 * bt.Lm:2 * bt.Lm + N_META]
    assert not meta[:, META_FAIL_CHASE].any()
    assert stats.shape == (want.shape[0], N_STATS)
    if kind == "event_overflow":
        assert meta[:, META_FAIL_REP].all()
        return
    assert not meta[:, META_FAIL_REP].any()
    steps, fills, replays = stats[:, 0], stats[:, 1], stats[:, 2]
    assert (steps >= meta[:, META_LEN] - 2).all()
    # a window of win cells a side holds at most 2 * win - 1 steps
    assert (fills >= -(-steps // (2 * win - 1))).all()
    if win == MAX_WINDOW and kind == "repeats":
        assert (fills == 1).all()          # these pairs fit one window
    if win <= 8 and kind == "merged_large_offsets":
        # some step jumps further than the window is wide (a miss by more
        # than one window) and the walk restarts there
        assert int(bt.O1.max()) > win and (fills > 2).all()
    if kind == "boundary_walk":
        assert (replays > 0).all()


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py checks the card")
    m = checks.model(0.5)
    pairs = [(checks.heavy(60, [2, 3, 5, 7], 1),
              checks.heavy(55, [2, 3, 4], 2), m)]
    items, _ = checks.items_and_expected(pairs)
    bt = gdp.pack_pairs([gdp.prep_pair(0, *items[0])], "cuda")
    Sd = exact_s(bt.g1T, bt.g2T, bt.M, bt.pi, bt.mi, bt.n1, bt.n2)
    fa = (Sd, bt.O1, bt.O2, bt.C1T, bt.C2T, bt.iv, bt.par, bt.Rmax)
    fo, fp = fill(*fa), fill_torch(*fa)
    for a, b in zip(fo, fp):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    ca = (bt.O1, bt.O2, bt.C1T, bt.C2T, bt.R1T, bt.R2T, bt.iv, bt.par, bt.Lm)
    want = chase_torch(fo, *ca)
    assert torch.equal(chase(fo, *ca), want)
    B, _, n1max = bt.g1T.shape
    for win, threads in ((2, 32), (8, 64), (32, 256), (MAX_WINDOW, 128)):
        plan = plan_chase(B, bt.O1.shape[1], n1max, bt.g2T.shape[2], win=win,
                          threads=threads)
        stats = torch.zeros((B, N_STATS), dtype=torch.int32, device="cuda")
        assert torch.equal(chase(fo, *ca, plan=plan, stats=stats), want)
        model = checks.chase_window_model(
            type(fo)(*(t.cpu() for t in fo)), *(t.cpu() for t in ca[:-1]),
            bt.Lm, win=win)[1]
        assert np.array_equal(stats.cpu().numpy(), model)
    _assert_batch(pairs, device="cuda")
