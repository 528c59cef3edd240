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
    DGROUPS, FILL_THREADS, MAX_DIM, S_CHAINS, S_DTILES, S_FILL_TILES,
    S_FIXED_DIMS, S_SMEM_MAX, S_THREADS, XVECS, exact_s, exact_s_torch,
    plan_s, plan_s_prep, s_col_floats, s_plane, s_plane_torch, s_prep,
    s_prep_torch, s_smem_bytes, unshear)
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


# (pairs, states, padded n1, largest n2) of the timed shapes and the edges
# of what K2 takes -> (rows y per block, diagonals per block)
S_PLAN_CASES = [
    ("fam100_largest_level", (39, 20, 216, 210), (128, 32)),
    ("chains_8x2000", (8, 20, 2008, 1982), (128, 64)),
    ("fam500_root_one_pair", (1, 20, 1520, 924), (128, 16)),
    ("fam500_level0", (186, 20, 320, 320), (128, 64)),
    ("one_short_dna_pair", (1, 4, 208, 203), (128, 8)),
    ("dna_level", (60, 4, 1200, 1200), (64, 64)),
    ("codon_level", (12, 61, 304, 301), (64, 16)),
    ("widest_states", (1, MAX_DIM, 2008, 2001), (128, 32)),
    ("width_not_compiled_in", (3, 23, 104, 100), (128, 8)),
    ("narrow_planes", (500, 20, 40, 36), (64, 64)),
    ("narrow_against_long", (64, 20, 40, 300), (64, 16)),
    ("one_narrow_pair_against_a_long_one", (1, 20, 40, 2000), (64, 8)),
    ("rows_just_over_half_a_block", (24, 20, 72, 300), (128, 8)),
    ("rows_not_padded", (5, 20, 203, 317), (128, 8)),
]


@pytest.mark.parametrize("name,shape,layout", S_PLAN_CASES,
                         ids=[c[0] for c in S_PLAN_CASES])
def test_plan_s_layout(name, shape, layout):
    B, dim, n1max, n2max = shape
    plan = plan_s(B, dim, n1max, n2max)
    assert (plan.threads, plan.dtile) == layout
    assert plan.threads in S_THREADS and plan.dtile in S_DTILES
    D = n1max + n2max - 1
    ytiles = -(-n1max // plan.threads)
    assert plan.grid == (ytiles, -(-D // plan.dtile), B)
    assert max(plan.grid[1:]) <= 65535
    assert plan.smem_bytes == s_smem_bytes(dim, plan.threads,
                                           plan.dtile) <= S_SMEM_MAX
    # the last y-tile is at least half rows of the plane, or blocks are the
    # smallest there are
    last = n1max - (ytiles - 1) * plan.threads
    assert 2 * last >= plan.threads or plan.threads == S_THREADS[-1]
    # a launch that can fill the card does, with the most diagonals per
    # block that still do and that fit the shared memory
    band = lambda d: B * ytiles * -(-(n2max + plan.threads - 1) // d)
    fits = [d for d in S_DTILES
            if s_smem_bytes(dim, plan.threads, d) <= S_SMEM_MAX]
    enough = [d for d in fits if band(d) >= S_FILL_TILES * SMS]
    assert plan.dtile == (enough[0] if enough else fits[-1])


def test_s_smem_bytes_columns():
    """A window column holds t2[0..dim) and v2; 16-byte reads where the
    width is compiled in want a length of 4 more than a multiple of 8
    floats, 4-byte reads an odd one, for lanes on neighbouring columns to
    fall on different banks."""
    for dim in range(1, MAX_DIM + 1):
        col = s_col_floats(dim)
        if dim in S_FIXED_DIMS:
            assert dim + 1 <= col <= dim + 8 and col % 8 == 4
            # a quarter of a warp, 16 bytes a lane, covers the 32 banks
            assert len({(col * lane + w) % 32 for lane in range(8)
                        for w in range(4)}) == 32
            assert s_smem_bytes(dim, 32, 8) == 4 * 39 * col
        else:
            assert dim + 1 <= col <= dim + 2 and col % 2 == 1
            assert len({col * lane % 32 for lane in range(32)}) == 32
            assert s_smem_bytes(dim, 32, 8) == 4 * (32 * dim + 39 * col)
    # diagonals are taken in whole groups of S_CHAINS
    assert S_CHAINS == 4
    assert s_smem_bytes(20, 64, 5) == s_smem_bytes(20, 64, 8)
    assert s_smem_bytes(20, 64, 4) < s_smem_bytes(20, 64, 5)


def test_plan_s_refuses_what_the_kernel_does_not_take():
    for bad in (dict(dim=0), dict(dim=MAX_DIM + 1), dict(threads=48),
                dict(threads=256), dict(threads=32),
                dict(dtile=0), dict(dtile=-4),
                dict(dtile=4096),                  # shared memory
                dict(dim=MAX_DIM, threads=128, dtile=64),
                dict(n2max=70000, dtile=1)):       # grid
        kw = dict(B=2, dim=20, n1max=200, n2max=204)
        kw.update(bad)
        with pytest.raises(ValueError):
            plan_s(**kw)
    for ok in (dict(dtile=1), dict(dtile=7),
               dict(n1max=100, n2max=104, threads=64,
                    dtile=204),                   # more than D diagonals
               dict(dim=MAX_DIM, threads=128, dtile=32)):
        kw = dict(B=2, dim=20, n1max=200, n2max=204)
        kw.update(ok)
        assert plan_s(**kw).dtile == ok["dtile"]
        assert plan_s(**kw).grid[1] == -(-(kw["n1max"] + kw["n2max"] - 1)
                                         // ok["dtile"])


# (n1max, n2max, n1 per pair, n2 per pair): a 3 x 2 pair beside long ones
# with sides that are no multiples of 4; n1 << n2 and n1 >> n2 with sides
# that are (tiles wholly below, above and across the band); one y-tile of
# padding rows only; a plane of fewer rows than a warp
S_MODEL_SHAPES = {
    "tiny_beside_long": (43, 57, (43, 3, 21), (57, 2, 57)),
    "n1_much_less_than_n2": (64, 132, (64, 10), (132, 131)),
    "n1_much_more_than_n2": (152, 12, (152, 90), (12, 5)),
    "padded_y_tile": (72, 30, (30, 17), (30, 9)),
    "fewer_rows_than_a_warp": (24, 45, (24, 5), (45, 33)),
}


# diagonals per block: one; 7 (no whole groups of S_CHAINS); 32; more than
# the plane has (None)
S_MODEL_DTILES = (1, 7, 32, None)


@pytest.mark.parametrize("dtile", S_MODEL_DTILES)
@pytest.mark.parametrize("threads", S_THREADS)
@pytest.mark.parametrize("shape", list(S_MODEL_SHAPES))
def test_s_tiles_own_each_position_once(shape, threads, dtile):
    """Under every layout each position of Sdiag is stored by exactly one
    thread of K2's grid (a band cell, a masked position of a group with
    cells, NEG of a group or of a tile without), every cell reads its own
    node x from a window column the tile filled, and the array that comes
    out is S sheared with NEG elsewhere."""
    n1max, n2max, n1, n2 = S_MODEL_SHAPES[shape]
    rng = np.random.RandomState(n1max + 7 * threads + (dtile or 0))
    D = n1max + n2max - 1
    d = np.arange(D)[:, None]
    y = np.arange(n1max)[None, :]
    plan = plan_s(len(n1), 20, n1max, n2max, threads=threads,
                  dtile=dtile or D + 5)
    S = [rng.rand(a, b).astype(np.float32) for a, b in zip(n1, n2)]
    owners, kinds, Sd = checks.s_tile_model(plan, 20, n1max, n2max, n1, n2, S)
    assert (owners == 1).all()
    for b in range(len(n1)):
        cell = (y < n1[b]) & (d - y >= 0) & (d - y < n2[b])
        assert ((kinds[b] == checks.S_OWNERS.index("cell")) == cell).all()
        assert (Sd[b][~cell] == np.float32(NEG)).all()
        yy, xx = np.nonzero(np.ones((n1[b], n2[b])))
        assert np.array_equal(Sd[b][yy + xx, yy], S[b][yy, xx])
    kinds_seen = {checks.S_OWNERS[k] for k in np.unique(kinds)}
    assert {"cell", "masked"} <= kinds_seen
    if dtile == 7:
        # tiles short enough to lie wholly outside a band, and groups of
        # diagonals on which a warp has no cell
        assert "neg_group" in kinds_seen
        if shape not in ("tiny_beside_long", "fewer_rows_than_a_warp"):
            assert "neg_tile" in kinds_seen


@pytest.mark.parametrize("dim", [4, 20, 23, 61, MAX_DIM])
def test_s_tile_model_notices_a_window_too_short(dim):
    """The shared memory plan_s asks for holds every column a tile reads,
    at each width, and the model is no rubber stamp: with one column less,
    or under a grid that is not the plan's, it raises."""
    shape = (72, 40, [72], [40])
    for dtile in (7, 8, 1):
        plan = plan_s(1, dim, 72, 40, threads=64, dtile=dtile)
        owners, _, _ = checks.s_tile_model(plan, dim, *shape)
        assert (owners == 1).all()
        short = plan._replace(smem_bytes=plan.smem_bytes - 4)
        with pytest.raises(AssertionError, match="column"):
            checks.s_tile_model(short, dim, *shape)
    with pytest.raises(AssertionError, match="grid"):
        checks.s_tile_model(plan._replace(threads=128), dim, *shape)


def test_s_tile_walk_reproduces_the_plain_plane():
    """The tile walk under the planner's own layout, fed the pairs' real S
    planes, gives the plain version's Sdiag bit for bit."""
    items, bt = _batch(_pairs("merged") + _pairs("chains"))
    Sdiag = exact_s_torch(bt.g1T, bt.g2T, bt.M, bt.pi, bt.mi, bt.n1, bt.n2)
    B, dim, n1max = bt.g1T.shape
    n2max = bt.g2T.shape[2]
    n1, n2 = bt.n1.tolist(), bt.n2.tolist()
    S = [unshear(Sdiag, a, b, k) for k, (a, b) in enumerate(zip(n1, n2))]
    for plan in (plan_s(B, dim, n1max, n2max),
                 plan_s(B, dim, n1max, n2max, threads=64, dtile=5)):
        owners, _, Sd = checks.s_tile_model(plan, dim, n1max, n2max, n1, n2,
                                            S)
        assert (owners == 1).all()
        assert np.array_equal(Sd.view(np.uint32),
                              Sdiag.numpy().view(np.uint32))


def test_batch_rows_start_on_sectors():
    """pack_pairs pads n1max to a multiple of 8 floats, so every row of the
    diagonal-major planes starts on a 32-byte sector; the padding rows are
    outside every pair."""
    items, bt = _batch(_pairs("chains"))
    n1max = bt.g1T.shape[2]
    most = max(g1.size for g1, _, _, _ in items)
    assert n1max % 8 == 0 and most <= n1max < most + 8
    assert int(bt.n1.max()) == most
    assert not bt.g1T[:, :, most:].any()


def test_wrappers_take_a_plan_on_the_cpu():
    """On CPU tensors s_plane and exact_s return the plain version whatever
    the plan."""
    items, bt = _batch(_pairs("chains")[:2])
    args = (bt.g1T, bt.g2T, bt.M, bt.pi, bt.mi, bt.n1, bt.n2)
    B, dim, n1max = bt.g1T.shape
    plan = plan_s(B, dim, n1max, bt.g2T.shape[2], threads=64, dtile=3)
    want = exact_s_torch(*args)
    assert torch.equal(exact_s(*args, plan=plan), want)
    t2, v2 = s_prep_torch(bt.g2T, bt.M, bt.pi)
    sa = (bt.g1T, t2, v2, bt.pi, bt.mi, bt.n1, bt.n2)
    assert torch.equal(s_plane(*sa, plan=plan), want)
    assert torch.equal(s_plane_torch(*sa), want)


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
        # K2 under every block size, odd tiles
        B, dim, n1max = bt.g1T.shape
        t2, v2 = s_prep(bt.g2T, bt.M, bt.pi)
        for threads in S_THREADS:
            for dtile in (1, 7, 32):
                got = s_plane(bt.g1T, t2, v2, bt.pi, bt.mi, bt.n1, bt.n2,
                              plan=plan_s(B, dim, n1max, bt.g2T.shape[2],
                                          threads=threads, dtile=dtile))
                assert torch.equal(got.view(torch.int32),
                                   Sk.view(torch.int32))
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
