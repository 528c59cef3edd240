"""The port's guide-tree distance stages against the JAX package, on the
same numpy-seeded inputs, with JAX on the CPU: NW counts (kernel D2's plain
version ``nw_torch``), the prealigned pair statistics (D1's plain version
``pair_stats_torch``), the angle distances' Gram on the card's path and the
CS mix.  The numpy models of D1's pack and word-parallel scan and of D2's
strip wavefront hold the kernels' own schedules against the host.  On the card
chip_smoke.py holds D1 and D2 against the same plain versions.
"""

import os

import numpy as np
import pytest
import torch

from prographmsa_tpu import cs_profile as ref_cs
from prographmsa_tpu.alphabet import AA_SPEC as REF_AA
from prographmsa_tpu.config import Options as RefOptions
from prographmsa_tpu.distances import angle as ref_angle
from prographmsa_tpu.distances.nw_device import nw_counts_device
from prographmsa_tpu.distances.prealigned_device import pair_stats_device
from prographmsa_tpu.models.factory import get_default_model_factory as ref_f
from prographmsa_tpu_torch import checks, native
from prographmsa_tpu_torch.alphabet import AA_SPEC, DNA_SPEC
from prographmsa_tpu_torch.config import Options
from prographmsa_tpu_torch.cs_profile import CSProfileLibrary
from prographmsa_tpu_torch.distances import angle
from prographmsa_tpu_torch.distances.align import (GAP_PARAMS, _load_scoring,
                                                   _seq_codes)
from prographmsa_tpu_torch.distances.nw_cuda import (SMEM_MAX, bits_per_pair,
                                                     nw_counts, nw_torch,
                                                     pairs_per_pass, plan_nw)
from prographmsa_tpu_torch.distances.prealigned import (_pair_stats,
                                                        _pair_stats_batch_host)
from prographmsa_tpu_torch.distances.prealigned_cuda import (
    count_dtype, pair_pack, pair_pack_torch, pair_stats, pair_stats_torch)
from prographmsa_tpu_torch.io.fasta import read_fasta
from prographmsa_tpu_torch.models.factory import get_default_model_factory

FIX = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "fixtures")
T = lambda a: torch.from_numpy(np.ascontiguousarray(a))


def _fasta_codes(name, n=None):
    seqs, _ = read_fasta(os.path.join(FIX, name))
    order = sorted(seqs)[:n]
    codes = [_seq_codes(AA_SPEC, AA_SPEC.encode(seqs[k])) for k in order]
    lens = np.array([len(c) for c in codes], np.int32)
    cm = np.zeros((len(codes), lens.max()), np.uint8)
    for i, c in enumerate(codes):
        cm[i, :len(c)] = c
    pi, pj = np.triu_indices(len(codes), 1)
    return cm[pi], cm[pj], lens[pi], lens[pj]


def _random_batch(rng, T_, B, L1, L2, zero=True, dtype=np.uint8):
    s1 = rng.integers(0, T_, (B, L1)).astype(dtype)
    s2 = rng.integers(0, T_, (B, L2)).astype(dtype)
    l1 = rng.integers(1, L1 + 1, B).astype(np.int32)
    l2 = rng.integers(1, L2 + 1, B).astype(np.int32)
    if zero:
        l1[0] = 0
        l2[1] = 0
        l1[2] = l2[2] = 0
    l1[3], l2[3] = L1, L2
    return s1, s2, l1, l2


def _nw_cases():
    rng = np.random.default_rng(7)
    aa = _load_scoring("aa")
    asym = rng.integers(-9, 12, (21, 21)).astype(np.int32)
    assert not np.array_equal(asym, asym.T)
    return {
        "fam6": (*_fasta_codes("fam6.fasta"), aa, *GAP_PARAMS["aa"], 20),
        "fam20": (*_fasta_codes("fam20.fasta", 12), aa, *GAP_PARAMS["aa"],
                  20),
        "asymmetric": (*_random_batch(rng, 21, 24, 47, 31), asym, -10, -2,
                       20),
        "codon": (*_random_batch(rng, 62, 10, 40, 45),
                  _load_scoring("codon"), *GAP_PARAMS["codon"], 61),
        "dna": (*_random_batch(rng, 5, 12, 38, 38, dtype=np.int32),
                _load_scoring("dna"), *GAP_PARAMS["dna"], 4),
        "strip_edges": (*checks.nw_strip_edge_pairs(rng, 1), asym, -10, -2,
                        20),
    }


NW_CASES = _nw_cases()


@pytest.mark.parametrize("case", list(NW_CASES))
def test_nw_torch_matches_jax_and_native(case):
    s1, s2, l1, l2, sc, go, ge, dim = NW_CASES[case]
    counts, gaps = nw_torch(T(s1), T(s2), T(l1), T(l2), T(sc), go, ge, dim)
    ref_c, ref_g = nw_counts_device(s1, s2, l1, l2, sc, go, ge, dim)
    nat_c, nat_g = native.nw_counts_native(s1, s2, l1, l2, sc, go, ge, dim)
    assert counts.dtype == torch.int32 and gaps.dtype == torch.int32
    assert np.array_equal(counts.numpy(), ref_c.astype(np.int64))
    assert np.array_equal(gaps.numpy(), np.asarray(ref_g))
    assert np.array_equal(counts.numpy(), nat_c)
    assert np.array_equal(gaps.numpy(), nat_g)
    assert counts.sum() > 0


@pytest.mark.parametrize("R", [1, 2, 4])
@pytest.mark.parametrize("case", ["asymmetric", "codon", "strip_edges"])
def test_nw_warp_model_matches_nw_torch(case, R):
    """D2's schedule (strips of 32 R rows, R rows a lane, the int8 score
    profile, the DPX predicates as backtrack bits, words keyed by step, the
    row buffer lane 31 refills) on the CPU, pair by pair."""
    s1, s2, l1, l2, sc, go, ge, dim = NW_CASES[case]
    counts, gaps = nw_torch(T(s1), T(s2), T(l1), T(l2), T(sc), go, ge, dim)
    for b in range(len(l1)):
        c, g = checks.nw_warp_model(s1[b, :l1[b]], s2[b, :l2[b]], sc, go, ge,
                                    dim, R)
        assert np.array_equal(c, counts[b].numpy()), b
        assert g == int(gaps[b]), b


@pytest.mark.parametrize("R", [1, 2, 4])
def test_nw_strips_cover_the_rows_once_within_the_scratch(R):
    """The strips D2 fills (32 R rows a lane while more than 16 R rows are
    left, then one narrower strip) cover rows 1 .. n2 once, end inside the
    pair's scratch rows, and the walk's closed form finds each row's."""
    for n2 in range(0, 700):
        strips = checks.nw_strip_rows(n2, R)
        rows = [y for y0, Rs in strips for y in range(y0, y0 + 32 * Rs)]
        assert rows == list(range(1, len(rows) + 1))
        assert n2 <= len(rows) <= -(-n2 // (32 * R)) * 32 * R
        assert all(Rs == R for _, Rs in strips[:-1])
        for y0, Rs in strips:
            for y in range(y0, min(y0 + 32 * Rs, n2 + 1)):
                assert checks.nw_strip_of(y, n2, R) == (y0, Rs)


def test_nw_counts_takes_the_plain_version_on_cpu():
    s1, s2, l1, l2, sc, go, ge, dim = NW_CASES["fam6"]
    a = nw_counts(T(s1), T(s2), T(l1), T(l2), T(sc), go, ge, dim)
    b = nw_torch(T(s1), T(s2), T(l1), T(l2), T(sc), go, ge, dim)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_plan_nw_sizes_launches_by_scratch():
    aa = (-4, 11)
    p = plan_nw(124750, 21, 319, 319, 20, aa)
    assert p.warps == 8 and p.smem_bytes <= SMEM_MAX and p.walk
    assert p.rows == 4
    bpp = bits_per_pair(319, 319, p.rows)
    assert p.pairs * bpp <= 1 << 29 < (p.pairs + 1) * bpp
    # few pairs: a warp a block, a block an SM
    p = plan_nw(8, 21, 2000, 1980, 20, aa)
    assert p.pairs == 8 and p.warps == 1
    assert plan_nw(4 * 132, 21, 319, 319, 20, aa).warps == 4
    # codon table and long pairs: fewer warps per block, never too much
    # shared memory
    p = plan_nw(40000, 62, 6000, 6000, 61, aa)
    assert p.warps == 2 and p.smem_bytes <= SMEM_MAX
    with pytest.raises(ValueError):
        plan_nw(1, 21, 40000, 40000, 20, aa)
    with pytest.raises(ValueError):
        plan_nw(1, 21, 300, 300, 20, aa, rows=3)
    assert plan_nw(1, 21, 300, 300, 20, aa, rows=1, walk=False)[3:] == (
        1, False)
    assert pairs_per_pass(319, 319, "cuda") == (
        (1 << 29) // bits_per_pair(319, 319, 4))
    assert pairs_per_pass(319, 319, "cpu") >= 1


def test_bits_per_pair_holds_every_strip_and_step():
    """A pair's scratch is whole strips of 32 R rows by the steps 0 .. L1 +
    31 at 16 a word, as csrc/nw.cu and checks.nw_warp_model lay it out."""
    for L1, L2 in ((1, 1), (32, 31), (47, 64), (80, 129), (319, 319)):
        for R in (1, 2, 4):
            strips = -(-L2 // (32 * R))
            steps = L1 + 32
            assert bits_per_pair(L1, L2, R) == 4 * strips * 32 * R * (
                -(-steps // 16))


@pytest.mark.parametrize("table", ["codon", "dna", "aa", "asymmetric"])
def test_plan_nw_takes_the_tables_in_int8(table):
    sc = NW_CASES["asymmetric"][4] if table == "asymmetric" else \
        _load_scoring(table)
    rng = (int(sc.min()), int(sc.max()))
    assert -128 <= rng[0] and rng[1] <= 127
    assert plan_nw(10, sc.shape[0], 40, 40, 20, rng).rows == 4


@pytest.mark.parametrize("lo,hi", [(-129, 11), (-4, 128), (-300, 300)])
def test_plan_nw_raises_on_a_table_outside_int8(lo, hi):
    with pytest.raises(ValueError, match="from %d to %d" % (lo, hi)):
        plan_nw(10, 21, 40, 40, 20, (lo, hi))
    sc = np.zeros((21, 21), np.int32)
    sc[3, 4], sc[5, 6] = lo, hi
    s1, s2, l1, l2 = _random_batch(np.random.default_rng(2), 21, 4, 9, 9)
    # on the CPU the plain version takes any table; the range is the card's
    nw_counts(T(s1), T(s2), T(l1), T(l2), T(sc), -10, -2, 20)
    with pytest.raises(ValueError, match="int8"):
        plan_nw(4, 21, 9, 9, 20, T(sc).aminmax())


def _random_msa(rng, chars, n, L):
    chars = list(chars) + ["-", "-", "X"]
    rows = []
    for _ in range(n):
        s = "".join(rng.choice(chars) for _ in range(L))
        rows.append(np.frombuffer(s.encode(), np.uint8).astype(np.int16))
    # an all-gap row, and two rows with a common run of gaps (both-gap
    # columns are transparent)
    rows[1][:] = ord("-")
    rows[2][10:25] = ord("-")
    rows[3][10:25] = ord("-")
    return rows


@pytest.mark.parametrize("alpha,cb", [("aa", 20), ("dna", 4)])
def test_pair_stats_torch_matches_jax_and_host(alpha, cb):
    spec = AA_SPEC if alpha == "aa" else DNA_SPEC
    rng = np.random.default_rng(11 if alpha == "aa" else 12)
    rows = _random_msa(rng, "ACDEFGHIKLMNPQRSTVWY" if alpha == "aa"
                       else "ACGT", 9, 77)
    vals = np.stack([spec.values(r) for r in rows]).astype(np.int32)
    gapm = np.stack([spec.is_gap(r) for r in rows])
    pi, pj = (a.astype(np.int32) for a in np.triu_indices(len(rows), 1))
    counts, gaps = pair_stats_torch(T(vals), T(gapm.astype(np.uint8)), T(pi),
                                    T(pj), cb)
    ref_c, ref_g = pair_stats_device(vals, gapm, pi, pj, cb, spec.DIM)
    host_c, host_g = _pair_stats_batch_host(vals, gapm, pi.astype(np.intp),
                                            pj.astype(np.intp), spec.DIM, cb)
    assert np.array_equal(counts.numpy(), ref_c[:, :cb, :cb])
    assert np.array_equal(gaps.numpy(), ref_g)
    assert np.array_equal(counts.numpy(), host_c[:, :cb, :cb])
    assert np.array_equal(gaps.numpy(), host_g)
    assert np.array_equal(
        pair_stats(T(vals), T(gapm.astype(np.uint8)), T(pi), T(pj), cb)[1],
        gaps)
    assert gaps.sum() > 0 and counts.sum() > 0


@pytest.mark.parametrize("L", [1, 31, 32, 33, 64, 100, 257, 1023, 1024,
                               1025, 2061])
def test_pair_stats_warp_gap_scan_model(L):
    """D1's gap openings, a word of 32 columns at a time in runs of
    ceil(W / 32) words a lane (1 to 3 words, 1 to 32 lanes busy here), the
    carry between lanes by ballots, against the host's per-pair state
    machine: random masks, all-gap rows, both-gap runs across words and
    lanes.  The counts walked off the bits agree too."""
    rng = np.random.default_rng(L)
    for k in range(12):
        g1 = rng.random(L) < 0.35
        g2 = rng.random(L) < 0.35
        if k % 3 == 0:
            g2[L // 4: 3 * L // 4] = g1[L // 4: 3 * L // 4] = True
        if k == 1:
            g1[:] = True
        if k == 2:
            g1[:] = g2[:] = True
        v = rng.integers(0, 21, (2, L))
        packed = checks.pair_pack_model(v, np.stack([g1, g2]), 20)
        counts, gaps = checks.pair_stats_word_model(*packed, [0], [1], 20)
        want = _pair_stats(v[0], g1, v[1], g2, 20, 20)
        assert gaps[0] == want[1]
        assert np.array_equal(counts[0], want[0])


def _pair_stats_all(vals, gapm, cb):
    """Every pair of the alignment through D1's numpy models, the plain
    versions and the host batch: (models, plain, host), each (counts,
    gaps), and the pairs."""
    pi, pj = (a.astype(np.int32) for a in np.triu_indices(len(vals), 1))
    packed = checks.pair_pack_model(vals, gapm, cb)
    plain_packed = pair_pack(T(vals), T(gapm), cb)
    for got, want in zip(plain_packed, packed):
        assert np.array_equal(got.numpy().view(want.dtype), want)
    model = checks.pair_stats_word_model(*packed, pi, pj, cb)
    c, g = pair_stats_torch(T(vals), T(gapm), T(pi), T(pj), cb)
    assert c.dtype == count_dtype(vals.shape[1])
    host = _pair_stats_batch_host(vals, gapm.astype(bool),
                                  pi.astype(np.intp), pj.astype(np.intp),
                                  cb, cb)
    return model, (c.numpy(), g.numpy()), host, (pi, pj)


@pytest.mark.parametrize("mask", checks.PAIR_MASKS)
@pytest.mark.parametrize("alpha", list(checks.PAIR_ALPHABETS))
def test_pair_stats_models_match_host_and_jax(alpha, mask):
    """D1's pack and statistics models and its plain versions, bit for bit
    against the host batch and the JAX program, on alignments built to
    break the word scan: transparent runs across 1-3 words and across a
    lane's boundary, whole lanes of transparent words entered with carry
    1, all-gap rows, residues never counted (AA X, DNA N, codons >= 20)."""
    vals, gapm, cb = checks.pair_stats_msa(alpha, mask)
    model, plain, host, (pi, pj) = _pair_stats_all(vals, gapm, cb)
    ref_c, ref_g = pair_stats_device(vals, gapm.astype(bool), pi, pj, cb, cb)
    for counts, gaps in (model, plain, host):
        assert np.array_equal(counts, ref_c)
        assert np.array_equal(gaps, ref_g)
    assert ref_g.sum() > 0 and ref_c.sum() > 0


def test_pair_stats_counts_in_int32_from_2_16_columns():
    """From 2^16 columns the counts are int32 (uint16 below); the models
    and the plain versions still agree with the host (65 words a lane)."""
    assert count_dtype((1 << 16) - 1) == torch.uint16
    assert count_dtype(1 << 16) == torch.int32
    vals, gapm, cb = checks.pair_stats_msa("aa", "runs_across_words", N=3,
                                           L=(1 << 16) + 37)
    model, plain, host, _ = _pair_stats_all(vals, gapm, cb)
    assert plain[0].dtype == np.int32
    for counts, gaps in (model, plain):
        assert np.array_equal(counts, host[0])
        assert np.array_equal(gaps, host[1])


def test_pair_lane_loads_count_each_lanes_bits():
    """The lane loads chip_smoke.py reports: the set bits of Ki & Kj in
    each lane's run of ceil(W / 32) words, and the fullest lane's bits word
    by word, summed."""
    rng = np.random.default_rng(5)
    K = rng.integers(0, 1 << 32, (5, 70), dtype=np.uint64).astype(np.uint32)
    pi, pj = np.triu_indices(5, 1)
    loads, steps = checks.pair_lane_loads(K, pi, pj)
    for p in range(len(pi)):
        bits = [bin(int(K[pi[p], q]) & int(K[pj[p], q])).count("1")
                for q in range(70)] + [0] * 26
        per = np.array(bits).reshape(32, 3)
        assert np.array_equal(loads[p], per.sum(1))
        assert steps[p] == per.max(0).sum()


@pytest.mark.cuda
def test_pair_stats_kernels_match_plain_versions():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py checks the card")
    for mask in checks.PAIR_MASKS:
        vals, gapm, cb = checks.pair_stats_msa("codon", mask)
        pi, pj = (T(a.astype(np.int32)).cuda()
                  for a in np.triu_indices(len(vals), 1))
        args = (T(vals).cuda(), T(gapm).cuda(), pi, pj)
        for got, want in zip(pair_pack(*args[:2], cb),
                             pair_pack_torch(*args[:2], cb)):
            assert torch.equal(got, want)
        for got, want in zip(pair_stats(*args, cb),
                             pair_stats_torch(*args, cb)):
            assert torch.equal(got.long(), want.long())


def _encoded(fixture):
    seqs, _ = read_fasta(os.path.join(FIX, fixture))
    enc = {}
    for k, v in seqs.items():
        e = AA_SPEC.encode(v)
        if len(e) and chr(e[0]) == "M":
            e = e[1:]
        enc[k] = e
    return enc


@pytest.mark.parametrize("fixture", ["fam20.fasta", "fam100.fasta",
                                     "fam500.fasta"])
def test_angle_device_bit_identical_to_jax(fixture):
    enc = _encoded(fixture)
    order = sorted(enc)
    d, v = angle.compute_angle_distances_device(AA_SPEC, enc, order,
                                                Options(), "cpu")
    rd, rv = ref_angle.compute_angle_distances_device(REF_AA, enc, order,
                                                      RefOptions())
    assert np.array_equal(d, rd, equal_nan=True)
    assert np.array_equal(v, rv, equal_nan=True)


def _cs_items(spec, factory_fn, options_cls):
    seqs, _ = read_fasta(os.path.join(FIX, "fam6.fasta"))
    opts = options_cls(sequence_file=os.path.join(FIX, "fam6.fasta"),
                       cs_file=os.path.join(FIX, "cs16.lib"), fasta_flag=True)
    fact = factory_fn(opts, spec, [spec.encode(s) for s in seqs.values()])
    return [(spec.encode(s), fact.get_model(0.3, opts))
            for s in seqs.values()]


def test_cs_mix_within_1e5_of_jax_and_host():
    """The float32 window scores and mix under ``device`` against JAX's
    ``_pk_mix_device`` and the host float64 path (TF32 plays no part on
    the CPU; the card's path sets it off)."""
    lib = os.path.join(FIX, "cs16.lib")
    items = _cs_items(AA_SPEC, get_default_model_factory, Options)
    ref_items = _cs_items(REF_AA, ref_f, RefOptions)
    host, dev = CSProfileLibrary(lib), CSProfileLibrary(lib)
    host.prime_profiles(items)
    dev.prime_profiles(items, "device", torch.device("cpu"))
    ref = ref_cs.CSProfileLibrary(lib)
    ref.prime_profiles(ref_items, engine="pallas")
    worst = 0.0
    for it, rit in zip(items, ref_items):
        pd = dev._cache[dev._key(*it)]
        worst = max(worst, np.max(np.abs(pd - host._cache[host._key(*it)])),
                    np.max(np.abs(pd - ref._cache[ref._key(*rit)])))
    assert worst < 1e-5, worst
    # the mix itself against JAX's on the same windows
    rng = np.random.default_rng(5)
    win = rng.integers(0, 21, (300, host.ncols))
    center = host.ncols // 2
    mine = dev._pk_mix_device(win, center, torch.device("cpu"))
    theirs = ref._pk_mix_device(win, center)
    assert np.max(np.abs(mine - theirs) / np.abs(theirs).max()) < 1e-5


def test_cs_mix_stays_on_host_except_under_device():
    items = _cs_items(AA_SPEC, get_default_model_factory, Options)
    for engine in ("torch", "auto", "native"):
        lib = CSProfileLibrary(os.path.join(FIX, "cs16.lib"))
        lib._pk_mix_device = lambda *a, **k: pytest.fail(engine)
        lib.prime_profiles(items, engine, torch.device("cpu"))


def test_nw_codes_beyond_the_table_score_zero_as_in_jax():
    """DNA with invalid residues: code 20 against the 5 x 5 table scores 0
    under the JAX device program's one-hot lookup; the port's distances
    map such codes onto a zero row and column, on every tier."""
    from prographmsa_tpu_torch.distances.align import compute_nw_distances
    rng = np.random.default_rng(3)
    seqs = {}
    for k in range(5):
        s = "".join(rng.choice(list("ACGTN"), 40 + k))
        seqs["s%d" % k] = DNA_SPEC.encode(s)
    order = sorted(seqs)
    codes = [_seq_codes(DNA_SPEC, seqs[k]) for k in order]
    assert max(c.max() for c in codes) == 20
    cm = np.zeros((5, 44), np.int32)
    for i, c in enumerate(codes):
        cm[i, :len(c)] = c
    lens = np.array([len(c) for c in codes], np.int32)
    pi, pj = np.triu_indices(5, 1)
    sc = _load_scoring("dna")
    ref_c, ref_g = nw_counts_device(cm[pi], cm[pj], lens[pi], lens[pj], sc,
                                    *GAP_PARAMS["dna"], 4)
    opts = Options(mldist_flag=True, nwdist_flag=True, dna_flag=True,
                   cmodel_file=os.path.join(FIX, "dna.qmat"))
    fac = get_default_model_factory(opts, DNA_SPEC)
    got = {}
    for engine, device in (("torch", "cpu"), ("native", None)):
        got[engine] = compute_nw_distances(DNA_SPEC, seqs, order, fac, opts,
                                           device, engine)
    assert all(np.array_equal(a, b) for a, b in zip(got["torch"],
                                                    got["native"]))
    cm5 = np.minimum(cm, 5)
    sc5 = np.pad(sc, ((0, 1), (0, 1)))
    mine = nw_torch(T(cm5[pi]), T(cm5[pj]), T(lens[pi]), T(lens[pj]),
                    T(sc5), *GAP_PARAMS["dna"], 4)
    assert np.array_equal(mine[0].numpy(), ref_c.astype(np.int64))
    assert np.array_equal(mine[1].numpy(), np.asarray(ref_g))


def test_nw_distances_in_chunks_equal_one_pass_and_native():
    """The card's chunk loop (each chunk's ML Newton after the next chunk's
    launch) on the plain version: chunks of 37 pairs, one pass and the
    native host kernel give the same distances."""
    from prographmsa_tpu_torch.distances.align import compute_nw_distances
    enc = _encoded("fam20.fasta")
    order = sorted(enc)
    opts = Options(mldist_flag=True, nwdist_flag=True)
    fac = get_default_model_factory(opts, AA_SPEC)
    runs = [compute_nw_distances(AA_SPEC, enc, order, fac, opts, "cpu",
                                 "torch", batch_pairs=37),
            compute_nw_distances(AA_SPEC, enc, order, fac, opts, "cpu",
                                 "torch"),
            compute_nw_distances(AA_SPEC, enc, order, fac, opts)]
    for d, v in runs[1:]:
        assert np.array_equal(d, runs[0][0]) and np.array_equal(v, runs[0][1])
