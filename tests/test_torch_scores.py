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
from prographmsa_tpu_torch.align.scores_cuda import (exact_s, exact_s_torch,
                                                     unshear)
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
