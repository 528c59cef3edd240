"""The port's exact-S plane (prographmsa_tpu_torch/align/scores_cuda.py) vs
the reference's host precompute_scores, bit for bit over full planes.

On the CPU the wrappers run the kernels' plain PyTorch versions.  The
reference's Pallas S kernel cannot run bit-exact on the CPU (XLA:CPU
contracts multiply-adds; align/scores_pallas.py), so its plain host
reference ``precompute_scores(engine="numpy")`` is the oracle.  The CUDA
kernels are held against the same oracle on the card (the ``cuda`` test
here, and chip_smoke.py).  Tolerance: none.
"""

import os

import numpy as np
import pytest
import torch

from prographmsa_tpu.align.graph_dp_pallas import NEG
from prographmsa_tpu.align.scores import DynProgScores, precompute_scores
from prographmsa_tpu.alphabet import get_alphabet
from prographmsa_tpu.config import Options
from prographmsa_tpu.graph.graph import sequence_graph
from prographmsa_tpu.io.fasta import read_fasta
from prographmsa_tpu.models.factory import CustomModelFactory, EcmModelFactory

from prographmsa_tpu_torch import _build, checks
from prographmsa_tpu_torch.align import graph_dp_cuda as gdp
from prographmsa_tpu_torch.align.fill_cuda import SMS
from prographmsa_tpu_torch.align.scores_cuda import (
    DGROUPS, FILL_THREADS, MAX_DIM, XVECS, exact_s, exact_s_torch,
    plan_s_prep, s_prep, s_prep_torch, unshear)
from prographmsa_tpu_torch.device import on_cuda, resolve_device

FIX = os.path.join(os.path.dirname(__file__), "..", "fixtures")


def _fixture_graphs(opts, fasta, k):
    spec = get_alphabet(opts)
    seqs, _ = read_fasta(os.path.join(FIX, fasta))
    return [sequence_graph(spec, spec.encode(s))
            for s in list(seqs.values())[:k]]


def _pairs(kind):
    """[(g1, g2, model, options)] for one family of inputs."""
    rng = np.random.RandomState(7)
    if kind == "chains":
        m = checks.model(0.4)
        return [(checks.chain(checks.random_seq(rng, 30 + 13 * k)),
                 checks.chain(checks.random_seq(rng, 25 + 17 * k)), m,
                 checks.OPTS) for k in range(3)]
    if kind == "merged":
        m = checks.model(0.3)
        s = checks.random_seq(rng, 60)
        cg = checks.merged(s, checks.mutated(rng, s, 6), m)
        g3 = checks.chain(checks.random_seq(rng, 41))
        return [(cg, g3, m, checks.OPTS), (g3, cg, m, checks.OPTS)]
    if kind == "dna":
        opts = Options(engine="native", dna_flag=True)
        with open(os.path.join(FIX, "dna.qmat")) as f:
            fac = CustomModelFactory(f.read(), 4)
        g = _fixture_graphs(opts, "dna12.fasta", 3)
        m = fac.get_model(0.2, opts)
        return [(g[0], g[1], m, opts), (g[2], g[0], m, opts)]
    opts = Options(engine="native", codon_flag=True)
    g = _fixture_graphs(opts, "orf10.fasta", 3)
    m = EcmModelFactory().get_model(0.3, opts)
    return [(g[0], g[1], m, opts), (g[1], g[2], m, opts)]


def _batch(pairs, device="cpu"):
    items = [(g1, g2, m, DynProgScores(g1, g2, m, o))
             for g1, g2, m, o in pairs]
    preps = [gdp.prep_pair(k, *it) for k, it in enumerate(items)]
    return items, gdp.pack_pairs(preps, device)


def _assert_planes(items, Sdiag):
    for b, (g1, g2, m, sc) in enumerate(items):
        Sh = precompute_scores(g1, g2, m, sc, engine="numpy")
        Sp = unshear(Sdiag, g1.size, g2.size, b)
        assert np.array_equal(Sh.view(np.uint32), Sp.view(np.uint32)), b


@pytest.mark.parametrize("kind", ["chains", "merged", "dna", "codon"])
def test_exact_s_matches_host_full_plane(kind):
    items, bt = _batch(_pairs(kind))
    Sdiag = exact_s(bt.g1T, bt.g2T, bt.M, bt.pi, bt.mi, bt.n1, bt.n2)
    _assert_planes(items, Sdiag)


def test_sentinel_rows_decode_the_x86_nan():
    """S on the all-zero sentinel rows is 0/0 -> the negative default NaN,
    which ls_log decodes into a finite ~384.8: the plane must carry exactly
    that value, not the decode of a positive NaN."""
    items, bt = _batch(_pairs("chains")[:1])
    S = unshear(exact_s_torch(bt.g1T, bt.g2T, bt.M, bt.pi, bt.mi, bt.n1,
                              bt.n2), items[0][0].size, items[0][1].size)
    g1, g2, m, sc = items[0]
    Sh = precompute_scores(g1, g2, m, sc, engine="numpy")
    for row in (S[0], S[-1], S[:, 0], S[:, -1]):
        assert np.all(np.isfinite(row)) and row.min() > 380.0
    assert np.array_equal(S.view(np.uint32), Sh.view(np.uint32))


def test_diagonal_layout_is_neg_outside_cells():
    items, bt = _batch(_pairs("chains"))
    Sdiag = exact_s(bt.g1T, bt.g2T, bt.M, bt.pi, bt.mi, bt.n1, bt.n2)
    B, D, n1max = Sdiag.shape
    assert D == bt.g1T.shape[2] + bt.g2T.shape[2] - 1
    d = torch.arange(D)[:, None]
    y = torch.arange(n1max)[None, :]
    for b, (g1, g2, _, _) in enumerate(items):
        cell = (y < g1.size) & (d - y >= 0) & (d - y < g2.size)
        assert torch.all(Sdiag[b][~cell] == torch.tensor(NEG))
        assert torch.all(Sdiag[b][cell] > torch.tensor(NEG))


def test_device_placement_rules():
    t = torch.zeros(2)
    assert on_cuda(t, t) is False
    with pytest.raises(ValueError):
        on_cuda(t, torch.zeros(2, device="meta"))
    assert resolve_device("cpu").type == "cpu"
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_kernel_argument_checks():
    """What a wrapper checks before it hands raw pointers to a kernel."""
    t = torch.zeros((2, 3))
    _build.check_args("k", (t, torch.float32, (2, 3)),
                      (t.int(), torch.int32, [2, 3]))
    for bad in ((t, torch.int32, (2, 3)), (t, torch.float32, (3, 2)),
                (t.t(), torch.float32, (3, 2))):
        with pytest.raises(ValueError, match="k: expected contiguous"):
            _build.check_args("k", bad)


def test_cuda_requested_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError):
        resolve_device("cuda")


# (pairs, states, largest n2) of the timed shapes (fam100's largest level,
# 8 x 2000 x 1980 chains, fam500's root pair) and the edges of what K1
# takes -> (outputs d per thread, nodes x per thread)
S_PREP_PLAN_CASES = [
    ("fam100_largest_level", (39, 20, 210), (8, 1)),
    ("chains_8x2000", (8, 20, 1982), (8, 1)),
    ("chains_n2max_multiple_of_4", (8, 20, 1980), (4, 4)),
    ("fam500_root_one_pair", (1, 20, 924), (1, 1)),
    ("fam500_level0", (186, 20, 320), (8, 4)),
    ("one_short_dna_pair", (1, 4, 203), (1, 1)),
    ("dna_level", (60, 4, 1200), (4, 4)),
    ("codon_level", (12, 61, 301), (8, 1)),
    ("widest_states", (1, MAX_DIM, 2001), (4, 1)),
]


def _s_prep_owners(plan, dim, n2max):
    """How many threads of K1's grid own each output t2[d, x] and v2[x] of
    one pair, as csrc/scores.cu indexes them."""
    t2 = np.zeros((dim, n2max), np.int64)
    v2 = np.zeros(n2max, np.int64)
    for bx in range(plan.grid[0]):
        for t in range(plan.threads):
            x0 = (bx * plan.threads + t) * plan.xvec
            if x0 >= n2max:
                continue
            xs = slice(x0, x0 + plan.xvec)
            for by in range(plan.grid[1]):
                d0 = by * plan.dgroup
                t2[d0:min(d0 + plan.dgroup, dim), xs] += 1
                if by == 0:
                    v2[xs] += 1
            assert x0 + plan.xvec <= n2max     # no store past the row
    return t2, v2


@pytest.mark.parametrize("name,shape,layout", S_PREP_PLAN_CASES,
                         ids=[c[0] for c in S_PREP_PLAN_CASES])
def test_plan_s_prep_layout(name, shape, layout):
    B, dim, n2max = shape
    plan = plan_s_prep(B, dim, n2max)
    assert (plan.dgroup, plan.xvec) == layout
    assert plan.dgroup in DGROUPS and plan.xvec in XVECS
    assert plan.xvec == 1 or n2max % 4 == 0
    assert plan.threads in (32, 64, 128)
    assert plan.grid[2] == B and max(plan.grid[1:]) <= 65535
    # shared memory: the group's columns of M and pi
    assert 4 * (MAX_DIM * plan.dgroup + MAX_DIM) <= 48 * 1024
    # a launch that can fill the card does, with the longest chains that
    # still do
    threads = B * plan.grid[1] * -(-n2max // plan.xvec)
    if B * dim * n2max >= SMS * FILL_THREADS:
        assert threads >= SMS * FILL_THREADS
    else:
        assert (plan.dgroup, plan.xvec) == (1, 1)
    t2, v2 = _s_prep_owners(plan, dim, n2max)
    assert (t2 == 1).all() and (v2 == 1).all()


@pytest.mark.parametrize("dgroup", DGROUPS)
@pytest.mark.parametrize("xvec,n2max", [(1, 203), (4, 204)])
def test_plan_s_prep_every_layout_owns_each_output_once(dgroup, xvec, n2max):
    for dim in (4, 20, 61, MAX_DIM):
        plan = plan_s_prep(3, dim, n2max, dgroup=dgroup, xvec=xvec)
        assert (plan.dgroup, plan.xvec) == (dgroup, xvec)
        t2, v2 = _s_prep_owners(plan, dim, n2max)
        assert (t2 == 1).all() and (v2 == 1).all()


def test_plan_s_prep_refuses_what_the_kernel_does_not_take():
    for bad in (dict(dim=0), dict(dim=MAX_DIM + 1), dict(dgroup=3),
                dict(n2max=203, xvec=4), dict(xvec=2)):
        kw = dict(B=2, dim=20, n2max=204)
        kw.update(bad)
        with pytest.raises(ValueError):
            plan_s_prep(**kw)


def _random_s_prep_inputs(B, dim, n2max, device="cpu"):
    rng = np.random.RandomState(B * 1000 + dim * 10 + n2max)
    t = lambda *shape: torch.from_numpy(
        rng.rand(*shape).astype(np.float32)).to(device)
    return t(B, dim, n2max), t(B, dim, dim), t(B, dim)


@pytest.mark.cuda
def test_cuda_s_kernels_match_plain_and_host():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py checks the card")
    for kind in ("chains", "merged", "dna", "codon"):
        items, bt = _batch(_pairs(kind), "cuda")
        args = (bt.g1T, bt.g2T, bt.M, bt.pi, bt.mi, bt.n1, bt.n2)
        Sk = exact_s(*args)
        assert torch.equal(Sk.view(torch.int32),
                           exact_s_torch(*args).view(torch.int32))
        _assert_planes(items, Sk)
    # K1 under every layout the planner can choose, at dim 4, 20, 61 and 64
    for dim in (4, 20, 61, MAX_DIM):
        for n2max in (203, 204):
            g2T, M, pi = _random_s_prep_inputs(3, dim, n2max, "cuda")
            want = s_prep_torch(g2T, M, pi)
            for dgroup in DGROUPS:
                for xvec in XVECS:
                    if xvec == 4 and n2max % 4:
                        continue
                    got = s_prep(g2T, M, pi, plan_s_prep(
                        3, dim, n2max, dgroup=dgroup, xvec=xvec))
                    for a, b in zip(got, want):
                        assert torch.equal(a.view(torch.int32),
                                           b.view(torch.int32))
