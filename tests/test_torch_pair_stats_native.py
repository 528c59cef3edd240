"""The host tier's prealigned pair statistics in native code
(``native/graphcore.cpp`` ``gc_pair_stats``, bound as
``native.pair_stats_native``) against the port's numpy batch
(``distances/prealigned.py`` ``_pair_stats_batch_numpy``) and the JAX
package's ``_pair_stats_batch_host``: counts and gap openings, exact
integers, on the golden alignments of c2_fam20 and c2_fam100 and on seeded
alignments (AA, DNA and codon values, values the counts skip, a row gapped
throughout, columns gapped in every row, 1 to 203 columns, pairs in any
order, i > j and i == j too) at one and several threads.  The prealigned
stage's float64 bits against the JAX stage with the library and without
it, and spies on which batch the stage takes.
"""

import numpy as np
import pytest

from prographmsa_tpu.distances import prealigned as ref_pre
from prographmsa_tpu_torch import native
from prographmsa_tpu_torch.alphabet import CODON_GAP, get_alphabet
from prographmsa_tpu_torch.config import Options
from prographmsa_tpu_torch.distances import prealigned as pre

from test_e2e_differential import G
from test_torch_prealigned_blocks import (DNA_MODEL, _case, _golden,
                                          _same_bits)

ALPHABETS = {"aa": {}, "dna": DNA_MODEL, "codon": dict(codon_flag=True)}


def _bound(spec):
    """The stage's count bound (prealigned.compute_prealigned_distances)."""
    return min(20, spec.DIM) if spec.name != "codon" else 20


def _msa(alpha, L, seed, n=9):
    """n rows of L codes as (values int32, gap flags bool, spec): 60% gaps,
    row 3 gapped throughout, every eighth column gapped in every row, and
    codes whose values the counts skip (AA's and DNA's X, codons from 20
    up)."""
    spec = get_alphabet(Options(**ALPHABETS[alpha]))
    rng = np.random.default_rng(seed)
    if spec.name == "codon":
        codes, gap = rng.integers(0, CODON_GAP, (n, L)), CODON_GAP
    else:
        letters = np.frombuffer(spec.inv_chars.encode(), np.uint8)
        codes = letters[rng.integers(0, len(letters), (n, L))]
        gap = spec.gap_code
    codes = codes.astype(np.int16)
    gapped = rng.random((n, L)) < 0.6
    gapped[:, 5::8] = True
    gapped[3] = True
    codes[gapped] = gap
    vals = np.stack([spec.values(r) for r in codes]).astype(np.int32)
    gapm = np.stack([spec.is_gap(r) for r in codes])
    return vals, gapm, spec


def _any_order(n, seed):
    """Every ordered pair of n rows, i == j too, shuffled."""
    pi, pj = (a.ravel() for a in np.indices((n, n)))
    order = np.random.default_rng(seed).permutation(len(pi))
    return pi[order], pj[order]


def _golden_input(name):
    spec = get_alphabet(Options())
    seqs = _golden(G + "/%s.fasta" % name, spec)
    order = sorted(seqs)
    vals = np.stack([spec.values(seqs[k]) for k in order]).astype(np.int32)
    gapm = np.stack([spec.is_gap(seqs[k]) for k in order])
    pi, pj = np.triu_indices(len(order), 1)
    return vals, gapm, pi, pj, spec.DIM, _bound(spec)


def _fuzz_input(alpha, L, pairs, seed):
    vals, gapm, spec = _msa(alpha, L, seed)
    if pairs == "single":
        pi, pj = np.array([5]), np.array([2])
    else:
        pi, pj = _any_order(len(vals), seed)
    return vals, gapm, pi, pj, spec.DIM, _bound(spec)


INPUTS = {"c2_fam20": lambda: _golden_input("c2_fam20"),
          "c2_fam100": lambda: _golden_input("c2_fam100")}
for _k, (_alpha, _L) in enumerate(
        (a, L) for a in ALPHABETS for L in (1, 63, 64, 65, 203)):
    INPUTS["%s_L%d" % (_alpha, _L)] = (
        lambda a=_alpha, L=_L, s=_k: _fuzz_input(a, L, "any", s))
INPUTS["aa_single_pair"] = lambda: _fuzz_input("aa", 203, "single", 99)


def _same(got, want):
    for a, b in zip(got, want):
        assert a.dtype == np.int64 and a.shape == b.shape
        assert np.array_equal(a, b)


@pytest.mark.parametrize("threads", ["1", "4"])
@pytest.mark.parametrize("name", list(INPUTS))
def test_native_equals_numpy_and_jax(monkeypatch, name, threads):
    """gc_pair_stats, the numpy batch and the JAX package's batch give the
    same counts and gap openings."""
    assert native.lib() is not None, "the native library did not build"
    monkeypatch.setenv("PROGRAPHMSA_THREADS", threads)
    vals, gapm, pi, pj, dim, cb = INPUTS[name]()
    got = native.pair_stats_native(vals, gapm, pi, pj, dim, cb)
    numpy_ = pre._pair_stats_batch_numpy(vals, gapm, pi, pj, dim, cb)
    jax_ = ref_pre._pair_stats_batch_host(vals, gapm, pi, pj, dim, cb)
    _same(got, numpy_)
    _same(got, jax_)
    _same(pre._pair_stats_batch_host(vals, gapm, pi, pj, dim, cb), jax_)
    assert got[0].shape == (len(pi), dim, dim)
    if len(vals[0]) > 1:
        assert got[0].sum() > 0 and got[1].sum() > 0


@pytest.mark.parametrize("values,flags", [
    ("int16", "bool"), ("int64", "uint8"), ("uint8", "bool"),
    ("int64_wide", "uint8_wide")])
def test_value_and_flag_types(values, flags):
    """Values of any integer type and gap flags of bool or uint8 type give
    the counts of int32 values and bool flags: a value whose low 32 bits
    lie in [0, count_bound) but which does not is still skipped, and a
    nonzero flag is a gap."""
    vals, gapm, pi, pj, dim, cb = _fuzz_input("aa", 65, "any", 7)
    want = pre._pair_stats_batch_numpy(vals, gapm, pi, pj, dim, cb)
    v = vals.astype(values.split("_")[0])
    if values == "int64_wide":
        v[vals < 0] = (1 << 32) + 3          # int32 would read 3
    g = gapm.astype(flags.split("_")[0])
    if flags == "uint8_wide":
        g *= 7
    _same(native.pair_stats_native(v, g, pi, pj, dim, cb), want)
    _same(pre._pair_stats_batch_host(v, g, pi, pj, dim, cb), want)


def test_a_row_index_out_of_range_raises():
    vals, gapm, pi, pj, dim, cb = _fuzz_input("aa", 63, "single", 3)
    for bad in (len(vals), -1):
        with pytest.raises(IndexError):
            native.pair_stats_native(vals, gapm, np.array([0, bad]),
                                     np.array([1, 2]), dim, cb)


STAGES = ("fam20", "c2_fam100", "fuzz_dna", "fuzz_codon_mldist")


@pytest.mark.parametrize("library", ["on", "off"])
@pytest.mark.parametrize("block", [0, 7], ids=["default", "7"])
@pytest.mark.parametrize("name", STAGES)
def test_stage_bits_with_and_without_the_library(monkeypatch, name, block,
                                                 library):
    """The stage's distances and variances keep the JAX stage's float64
    bits whichever batch counts, and each block goes through that batch
    (spies on both)."""
    args, want = _case(name)
    if library == "off":
        monkeypatch.setattr(native, "lib", lambda: None)
    calls = {"native": [], "numpy": []}
    nat, num = native.pair_stats_native, pre._pair_stats_batch_numpy

    def nat_spy(vmat, gmat, pi, *rest):
        got = nat(vmat, gmat, pi, *rest)
        if got is not None:
            assert vmat.dtype == np.int32 and gmat.dtype == np.bool_
            calls["native"].append(len(pi))
        return got

    def num_spy(vmat, gmat, pi, *rest):
        calls["numpy"].append(len(pi))
        return num(vmat, gmat, pi, *rest)
    monkeypatch.setattr(native, "pair_stats_native", nat_spy)
    monkeypatch.setattr(pre, "_pair_stats_batch_numpy", num_spy)
    got = pre.compute_prealigned_distances(*args, block_pairs=block)
    _same_bits(got, want)
    n = len(args[2])
    taken = "native" if library == "on" else "numpy"
    assert sum(calls[taken]) == n * (n - 1) // 2
    assert not calls["numpy" if library == "on" else "native"]
    if block:
        assert set(calls[taken][:-1]) <= {block}


def test_a_failing_library_raises_and_is_not_retried(monkeypatch):
    """A library that loads and then fails is an error: the stage raises
    and never runs the numpy batch."""
    args, _ = _case("fam20")

    def broken(*a):
        raise RuntimeError("gc_pair_stats failed")
    monkeypatch.setattr(native, "pair_stats_native", broken)
    monkeypatch.setattr(pre, "_pair_stats_batch_numpy",
                        lambda *a: pytest.fail("retried in numpy"))
    with pytest.raises(RuntimeError, match="gc_pair_stats"):
        pre.compute_prealigned_distances(*args)


@pytest.mark.parametrize("library", ["on", "off"])
def test_auto_prices_the_host_batch_it_would_run(monkeypatch, library):
    """``auto`` weighs D1 against the native batch on the host's threads,
    or against the numpy batch where the library is unavailable: a card
    between the two costs takes the stage only from the numpy batch."""
    from prographmsa_tpu_torch import engine_policy as EP
    P, L, threads = 124750, 2061, 8
    work = float(P) * L
    native_s = work / (EP.PAIR_STATS_HOST_RATE * threads)
    numpy_s = work / EP.PAIR_STATS_NUMPY_RATE
    assert native_s < numpy_s
    rt = (native_s + numpy_s) / 4      # one call of D1: two round trips
    monkeypatch.setattr(EP, "calibration", lambda: {
        "roundtrip_s": rt, "fetch_mbps": 1e12, "device": "card",
        "host_threads": threads})
    if library == "off":
        monkeypatch.setattr(native, "lib", lambda: None)
    assert EP.use_device_prealigned("auto", P, L, 20) == (library == "off")
