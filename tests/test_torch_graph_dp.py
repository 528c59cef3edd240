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
from prographmsa_tpu_torch.align.fill_cuda import fill, fill_torch
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
