"""The prealigned distance stage streamed over blocks of pairs
(prographmsa_tpu_torch/distances/prealigned.py), against the JAX package's
stage, which takes every pair at once: the float64 bits of distances and
variances at blocks of 1, 3 and 7 pairs and the default, on the host tier
and on the card's path through its plain twin (``engine="torch"``, the
CPU).  Inputs: the golden alignments of fam20 and c2_fam100, and seeded
gappy alignments (columns gapped in every row, an all-gap row, values the
counts skip, DNA and codon).  Spies on the two batch functions hold each
call to its block's size.
"""

import functools

import numpy as np
import pytest

from prographmsa_tpu.alphabet import get_alphabet as ref_get_alphabet
from prographmsa_tpu.config import Options as RefOptions
from prographmsa_tpu.distances import prealigned as ref_pre
from prographmsa_tpu.models.factory import (
    get_default_model_factory as ref_factory)
from prographmsa_tpu_torch.alphabet import CODON_GAP, get_alphabet
from prographmsa_tpu_torch.config import Options
from prographmsa_tpu_torch.distances import prealigned as pre
from prographmsa_tpu_torch.io.fasta import read_fasta
from prographmsa_tpu_torch.models.factory import get_default_model_factory

from test_e2e_differential import FIX, G

DNA_MODEL = dict(dna_flag=True, cmodel_file=FIX + "/dna.qmat")
KINDS = {"aa": {}, "aa_mldist": dict(mldist_flag=True), "dna": DNA_MODEL,
         "codon": dict(codon_flag=True),
         "codon_mldist": dict(codon_flag=True, mldist_flag=True)}


def _golden(path, spec):
    """A golden alignment's rows as codes, the gap code in gapped columns."""
    seqs, _ = read_fasta(path)
    out = {}
    for n, s in seqs.items():
        col = np.array(list(s)) != "-"
        enc = np.full(len(s), spec.gap_code, dtype=np.int16)
        enc[col] = spec.encode(s.replace("-", ""))
        out[n] = enc
    return out


def _fuzz(spec, seed, n=23, L=157):
    """n rows of L codes: 70% gaps, runs of columns gapped in every row, row
    3 gapped throughout, codes whose values the counts skip (AA's X, DNA's
    X, codons' values from 20 up)."""
    rng = np.random.default_rng(seed)
    if spec.name == "codon":
        codes, gap = rng.integers(0, CODON_GAP, (n, L)), CODON_GAP
    else:
        letters = np.frombuffer(spec.inv_chars.encode(), np.uint8)
        codes = letters[rng.integers(0, len(letters), (n, L))]
        gap = spec.gap_code
    codes = codes.astype(np.int16)
    gapped = rng.random((n, L)) < 0.7
    gapped[:, 10:14] = gapped[:, 60:61] = gapped[:, L - 5:] = True
    gapped[3] = True
    codes[gapped] = gap
    return {"s%02d" % k: codes[k] for k in range(n)}


INPUTS = {"fam20": ("aa", G + "/c2_fam20.fasta"),
          "fam20_mldist": ("aa_mldist", G + "/c2_fam20.fasta"),
          "c2_fam100": ("aa_mldist", G + "/c2_fam100.fasta"),
          "fuzz_aa": ("aa", 0), "fuzz_aa_mldist": ("aa_mldist", 1),
          "fuzz_dna": ("dna", 2), "fuzz_codon": ("codon", 3),
          "fuzz_codon_mldist": ("codon_mldist", 4)}


@functools.lru_cache(maxsize=None)
def _case(name):
    """(the port's stage arguments, the JAX package's distances and
    variances) of input ``name``."""
    kind, src = INPUTS[name]
    opts, ropts = Options(**KINDS[kind]), RefOptions(engine="native",
                                                     **KINDS[kind])
    spec, rspec = get_alphabet(opts), ref_get_alphabet(ropts)
    seqs = _golden(src, spec) if isinstance(src, str) else _fuzz(spec, src)
    order = sorted(seqs)
    vals = {k: spec.values(s) for k, s in seqs.items()}
    fac = get_default_model_factory(opts, spec, vals)
    want = ref_pre.compute_prealigned_distances(
        rspec, seqs, order, ref_factory(ropts, rspec, vals), ropts)
    return (spec, seqs, order, fac, opts), want


def _same_bits(got, want):
    for a, b in zip(got, want):
        assert a.dtype == np.float64 and a.shape == b.shape
        assert np.array_equal(a.view(np.int64), b.view(np.int64))


def _spy(monkeypatch, name):
    calls = []
    fn = getattr(pre, name)

    def spy(vmat, gmat, pi, pj, *rest):
        calls.append((len(pi), vmat.shape[1]))
        return fn(vmat, gmat, pi, pj, *rest)
    monkeypatch.setattr(pre, name, spy)
    return calls


@pytest.mark.parametrize("tier", ["native", "torch"])
@pytest.mark.parametrize("block", [1, 3, 7, 0], ids=["1", "3", "7", "default"])
@pytest.mark.parametrize("name", list(INPUTS))
def test_blocks_match_the_jax_stage_bit_for_bit(monkeypatch, name, block,
                                                tier):
    if name == "c2_fam100" and block in (1, 3):
        block *= 61         # 4,950 pairs: blocks that do not divide them
    args, want = _case(name)
    calls = _spy(monkeypatch, "_pair_stats_batch_host" if tier == "native"
                 else "_pair_stats_on_card")
    got = pre.compute_prealigned_distances(*args, device="cpu", engine=tier,
                                           block_pairs=block)
    _same_bits(got, want)
    n = len(args[2])
    P = n * (n - 1) // 2
    step = block or (pre.CARD_BLOCK_PAIRS if tier == "torch"
                     else pre.host_block_pairs(calls[0][1]))
    assert [p for p, _ in calls] == [min(step, P - s)
                                     for s in range(0, P, step)]


@pytest.mark.parametrize("budget_rows", [1, 5, 64])
def test_no_host_block_exceeds_its_budget(monkeypatch, budget_rows):
    """The host batch never gets more pair-columns than the budget (at
    least one pair), and the blocks cover every pair once."""
    args, want = _case("fuzz_aa_mldist")
    L = len(next(iter(args[1].values())))
    monkeypatch.setattr(pre, "HOST_BLOCK_PAIR_COLUMNS", budget_rows * L + 3)
    calls = _spy(monkeypatch, "_pair_stats_batch_host")
    got = pre.compute_prealigned_distances(*args)
    _same_bits(got, want)
    n = len(args[2])
    assert sum(p for p, _ in calls) == n * (n - 1) // 2
    assert all(p * cols <= pre.HOST_BLOCK_PAIR_COLUMNS for p, cols in calls)
    assert [p for p, _ in calls[:-1]] == [budget_rows] * (len(calls) - 1)


def test_no_card_block_exceeds_its_pairs(monkeypatch):
    args, want = _case("fuzz_codon_mldist")
    monkeypatch.setattr(pre, "CARD_BLOCK_PAIRS", 40)
    calls = _spy(monkeypatch, "_pair_stats_on_card")
    got = pre.compute_prealigned_distances(*args, device="cpu",
                                           engine="torch")
    _same_bits(got, want)
    assert [p for p, _ in calls] == [40] * 6 + [13]


def test_host_block_sizes_follow_the_alignment_length():
    assert pre.host_block_pairs(3516) == (1 << 24) // 3516 == 4771
    assert pre.host_block_pairs(1922) == 8729
    assert pre.host_block_pairs(1 << 25) == 1
    assert pre.host_block_pairs(0) == 1 << 24


@pytest.mark.parametrize("n,blocks", [(500, [124750]),
                                      (1000, [1 << 17] * 3 + [106284])])
def test_card_blocks_of_a_re_tree(monkeypatch, n, blocks):
    """500 rows (124,750 pairs) are one call of D1, 1,000 rows (499,500)
    four; every pair's distance lands in both halves of the matrix."""
    calls = []

    def stats(vmat, gmat, pi, pj, dim, cb, device):
        calls.append(len(pi))
        return pi.astype(np.int64), pj.astype(np.int64)

    def distances(counts, gaps, seqlens, *rest):
        return counts * 1000.0 + gaps, seqlens
    monkeypatch.setattr(pre, "_pair_stats_on_card", stats)
    monkeypatch.setattr(pre, "compute_distances_batch", distances)
    spec = get_alphabet(Options())
    seqs = {"s%04d" % k: np.full(2, spec.gap_code, np.int16)
            for k in range(n)}
    d, v = pre.compute_prealigned_distances(spec, seqs, sorted(seqs), None,
                                            Options(), device="cpu",
                                            engine="torch")
    assert calls == blocks
    i, j = np.triu_indices(n, 1)
    assert np.array_equal(d[i, j], i * 1000.0 + j)
    assert np.array_equal(d[j, i], i * 1000.0 + j)
    assert np.all(v[i, j] == 2.0) and np.all(np.diag(d) == 0)


@pytest.mark.parametrize("n", [0, 1, 2, 5, 9, 40])
def test_triu_order_is_the_old_pair_list(n):
    pi, pj = np.triu_indices(n, 1)
    assert list(zip(pi.tolist(), pj.tolist())) == [
        (i, j) for i in range(n) for j in range(i + 1, n)]


@pytest.mark.parametrize("tier", ["native", "torch"])
def test_eight_pairs_or_fewer(tier):
    """Four rows: the host's per-pair path, or D1's twin, as one block."""
    (spec, seqs, order, fac, opts), _ = _case("fuzz_aa")
    few = order[:4]
    vals = {k: spec.values(seqs[k]) for k in few}
    ropts = RefOptions(engine="native")
    rspec = ref_get_alphabet(ropts)
    want = ref_pre.compute_prealigned_distances(
        rspec, {k: seqs[k] for k in few}, few,
        ref_factory(ropts, rspec, vals), ropts)
    got = pre.compute_prealigned_distances(spec, seqs, few, fac, opts,
                                           device="cpu", engine=tier)
    _same_bits(got, want)


def test_auto_prices_a_round_trip_pair_per_card_block(monkeypatch):
    """``auto`` pays an upload and a fetch for each call of D1: 499,500
    pairs of one column cost four calls' round trips, which lose to the
    host where one call's would win.  The round trip is a quarter of the
    host's time, the native batch's on eight threads."""
    from prographmsa_tpu_torch import engine_policy as EP
    host_s = 499500 / (EP.PAIR_STATS_HOST_RATE * 8)
    rt = host_s / 4
    monkeypatch.setattr(EP, "calibration", lambda: {
        "roundtrip_s": rt, "fetch_mbps": 1e12, "device": "card",
        "host_threads": 8})
    assert 2 * rt < host_s < 2 * 4 * rt
    assert not EP.use_device_prealigned("auto", 499500, 1, 20)
    monkeypatch.setattr(pre, "CARD_BLOCK_PAIRS", 1 << 19)
    assert EP.use_device_prealigned("auto", 499500, 1, 20)
