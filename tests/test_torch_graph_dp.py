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
    META_FAIL_CHASE, META_FAIL_REP, N_META, chase, chase_torch, row_width)
from prographmsa_tpu_torch.align.fill_cuda import (
    LANE_THREADS, MAX_BLOCKS_PER_PAIR, MAX_THREADS, SMEM_BYTES, SMS,
    WIDE_BLOCKS_PER_PAIR, card_limits, fill, fill_torch, plan_fill)
from prographmsa_tpu_torch.align.slots import FLOOR
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
    """Pairs the batch refuses: the same reason as the reference's prep
    (size over MAX_N, too many offsets, too long a reach)."""
    rng = np.random.RandomState(3)
    m = checks.model(0.3)
    small = _chain_of(20, rng)
    cases = {
        "fb_size": (_chain_of(gdp.MAX_N + 1, rng), small),
        "fb_offsets": (checks.many_offsets_graph(80, 70, 1), small),
        "fb_reach": (checks.heavy(270, [250], 2), checks.heavy(270, [250],
                                                               3)),
    }
    for reason, (g1, g2) in cases.items():
        sc = checks.DynProgScores(g1, g2, m, checks.OPTS)
        assert ref_gdp._prep_pair(0, g1, g2, m, sc) == reason
        assert gdp.prep_pair(0, g1, g2, m, sc) == reason
        before = gdp.fallback_stats()
        assert gdp.align_pairs_device([(g1, g2, m, sc)], "cpu") == [None]
        after = gdp.fallback_stats()
        assert after[reason] == before[reason] + 1
        assert after["pairs_device"] == before["pairs_device"]


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
    assert torch.equal(chase(fo, *ca), chase_torch(fo, *ca))
    _assert_batch(pairs, device="cuda")
