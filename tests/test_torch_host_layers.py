"""Every host layer the port copied, against the JAX package's original:
the same numpy inputs (made from a seed, or the fam20 fixture) go through
``prographmsa_tpu`` and through ``prographmsa_tpu_torch`` and the results
must be equal exactly (host code in numpy and C++, the same operations in
the same order: no tolerance).  Graphs, models and scores cross from one
package to the other as plain arrays through the port's
``convert.to_arrays`` / ``from_reference_arrays``.
"""

import numpy as np
import pytest

from prographmsa_tpu import alphabet as ref_al
from prographmsa_tpu import native as ref_native
from prographmsa_tpu.align import backtrack as ref_bt
from prographmsa_tpu.align import dp as ref_dp
from prographmsa_tpu.align import graph_dp_pallas as ref_gdp
from prographmsa_tpu.align import merge as ref_merge
from prographmsa_tpu.align import scores as ref_scores
from prographmsa_tpu.config import Options as RefOptions
from prographmsa_tpu.distances import angle as ref_angle
from prographmsa_tpu.distances import align as ref_nw
from prographmsa_tpu.distances import prealigned as ref_pre
from prographmsa_tpu.graph import graph as ref_graph
from prographmsa_tpu.io import fasta as ref_fasta
from prographmsa_tpu.io import newick as ref_newick
from prographmsa_tpu.models import factory as ref_factory
from prographmsa_tpu.tree import treenj as ref_treenj

from prographmsa_tpu_torch import alphabet as al
from prographmsa_tpu_torch import convert, native
from prographmsa_tpu_torch.align import backtrack as bt
from prographmsa_tpu_torch.align import dp
from prographmsa_tpu_torch.align import merge
from prographmsa_tpu_torch.align import scores
from prographmsa_tpu_torch.align import slots
from prographmsa_tpu_torch.config import Options
from prographmsa_tpu_torch.distances import angle
from prographmsa_tpu_torch.distances import align as nw
from prographmsa_tpu_torch.distances import prealigned as pre
from prographmsa_tpu_torch.graph import graph
from prographmsa_tpu_torch.io import fasta, newick
from prographmsa_tpu_torch.models import factory
from prographmsa_tpu_torch.tree import treenj

from test_e2e_differential import FIX, G

AAS = list("ACDEFGHIKLMNPQRSTVWY")
REP = dict(repeat_rate=0.5, repeatext_prob=0.3)


def _seq(rng, n):
    return "".join(rng.choice(AAS, n))


def _mutate(rng, s, n_del):
    chars = list(s)
    for k in sorted(rng.choice(len(chars), n_del, replace=False),
                    reverse=True):
        del chars[k]
    return "".join(rng.choice(AAS) if rng.rand() < 0.1 else c for c in chars)


def _same_graph(a, b):
    assert np.array_equal(a.sites, b.sites)
    assert a.size == b.size
    for i in range(a.size):
        assert [(p, np.float32(c)) for p, c in a.preds[i]] == \
            [(p, np.float32(c)) for p, c in b.preds[i]], i
        assert [tuple(r) for r in a.reps[i]] == \
            [tuple(r) for r in b.reps[i]], i


def _same_aln(a, b):
    assert list(a.mapping1) == list(b.mapping1)
    assert list(a.mapping2) == list(b.mapping2)
    assert np.float32(a.score) == np.float32(b.score)
    assert a.n_tr_indels == b.n_tr_indels


class Pair:
    """One alignment step built in the JAX package from a seed, and the
    port's objects made from its flat arrays."""

    def __init__(self, seed, merged=False, repeats=False):
        rng = np.random.RandomState(seed)
        kw = REP if repeats else {}
        self.ref_opts = RefOptions(engine="numpy", **kw)
        self.opts = Options(engine="numpy", **kw)
        spec = ref_al.AA_SPEC
        s1 = _seq(rng, rng.randint(30, 60))
        if repeats:
            unit = _seq(rng, 4)
            s1 = s1[:10] + unit * 3 + s1[10:]
        g1 = ref_graph.sequence_graph(spec, spec.encode(s1))
        if repeats:
            tr = np.full(g1.size, -1, dtype=np.int64)
            tr[11:23] = np.tile(np.arange(4), 3)
            g1.add_repeats([tr])
        g2 = ref_graph.sequence_graph(
            spec, spec.encode(_mutate(rng, s1, rng.randint(3, 8))))
        self.ref_factory = ref_factory.WagModelFactory()
        m = self.ref_factory.get_model(0.2 + 0.1 * seed, self.ref_opts)
        if merged:
            sc = ref_scores.DynProgScores(g1, g2, m, self.ref_opts)
            S = ref_scores.precompute_scores(g1, g2, m, sc, engine="numpy")
            aln = ref_bt.backtrack(g1, g2, ref_dp.fill_dp(g1, g2, S, sc), sc)
            anc = ref_merge.merge_graphs(g1, g2, aln.mapping1, aln.mapping2,
                                         m, m, 0.5, 0.5, self.ref_opts)
            g1 = ref_graph.clean_graph(anc.graph, self.ref_opts)[0]
            g2 = ref_graph.sequence_graph(
                spec, spec.encode(_mutate(rng, s1, 5)))
        sc = ref_scores.DynProgScores(g1, g2, m, self.ref_opts)
        self.ref = (g1, g2, m, sc)
        self.arrays = convert.to_arrays(g1, g2, m, sc)
        self.port = convert.from_reference_arrays(self.arrays)


PAIRS = {"chains": dict(seed=1), "merged": dict(seed=2, merged=True),
         "repeats": dict(seed=3, repeats=True),
         "merged_repeats": dict(seed=4, merged=True, repeats=True)}


@pytest.fixture(scope="module", params=list(PAIRS))
def pair(request):
    return Pair(**PAIRS[request.param])


def test_from_reference_arrays_round_trip(pair):
    g1, g2, m, sc = pair.port
    _same_graph(g1, pair.ref[0])
    _same_graph(g2, pair.ref[1])
    again = convert.to_arrays(g1, g2, m, sc)
    for side in ("g1", "g2"):
        for k, v in pair.arrays[side].items():
            assert np.array_equal(v, again[side][k]), (side, k)
    for k in ("M", "pi", "P", "Q"):
        assert np.array_equal(pair.arrays[k], again[k]), k
    assert pair.arrays["model"] == again["model"]
    assert pair.arrays["scores"] == again["scores"]


def test_sequence_graph_and_clean_graph(pair):
    rng = np.random.RandomState(7)
    s = _seq(rng, 40)
    _same_graph(graph.sequence_graph(al.AA_SPEC, al.AA_SPEC.encode(s)),
                ref_graph.sequence_graph(ref_al.AA_SPEC,
                                         ref_al.AA_SPEC.encode(s)))
    for eng in ("numpy", "native"):
        cg, om = graph.clean_graph(pair.port[0],
                                   pair.opts.replace(engine=eng))
        rcg, rom = ref_graph.clean_graph(pair.ref[0],
                                         pair.ref_opts.replace(engine=eng))
        _same_graph(cg, rcg)
        assert np.array_equal(om, rom)


def test_dynprog_scores_and_precompute_scores(pair):
    g1, g2, m, sc = pair.port
    mine = scores.DynProgScores(g1, g2, m, pair.opts)
    for k in convert.SCORE_FIELDS:
        assert np.float32(getattr(mine, k)).tobytes() == \
            np.float32(getattr(pair.ref[3], k)).tobytes(), k
    S = scores.precompute_scores(g1, g2, m, sc, engine="numpy")
    Sr = ref_scores.precompute_scores(*pair.ref, engine="numpy")
    assert np.array_equal(S.view(np.uint32), Sr.view(np.uint32))
    assert (scores._LS_A, scores._LS_B, scores._LS_C) == \
        (ref_scores._LS_A, ref_scores._LS_B, ref_scores._LS_C)
    x = np.abs(np.random.RandomState(0).randn(64)).astype(np.float32)
    assert np.array_equal(scores.ls_log_add(x, np.float32(0.5)),
                          ref_scores.ls_log_add(x, np.float32(0.5)))


def test_fill_dp_backtrack_and_native_align_node(pair):
    g1, g2, m, sc = pair.port
    S = scores.precompute_scores(g1, g2, m, sc, engine="numpy")
    mats = dp.fill_dp(g1, g2, S, sc)
    rmats = ref_dp.fill_dp(*pair.ref[:2], S, pair.ref[3])
    for name in ("M", "X", "Y", "W"):
        a, b = getattr(mats, name), getattr(rmats, name)
        assert np.array_equal(a.view(np.uint32), b.view(np.uint32)), name
    aln = bt.backtrack(g1, g2, mats, sc)
    _same_aln(aln, ref_bt.backtrack(*pair.ref[:2], rmats, pair.ref[3]))
    assert native.available() and ref_native.available()
    assert native._SO != ref_native._SO
    nat = native.align_node_native(g1, g2, m, sc)
    rnat = ref_native.align_node_native(*pair.ref)
    assert (nat is None) == (rnat is None)
    if nat is not None:        # the fused tier declines repeat graphs
        _same_aln(nat, rnat)
        _same_aln(nat, aln)
    Sn = native.precompute_scores_native(g1, g2, m, sc.match_init)
    assert np.array_equal(Sn.view(np.uint32), S.view(np.uint32))


def test_merge_graphs(pair):
    g1, g2, m, sc = pair.port
    S = scores.precompute_scores(g1, g2, m, sc, engine="numpy")
    aln = bt.backtrack(g1, g2, dp.fill_dp(g1, g2, S, sc), sc)
    for eng in ("numpy", "native"):
        anc = merge.merge_graphs(g1, g2, aln.mapping1, aln.mapping2, m, m,
                                 0.4, 0.7, pair.opts.replace(engine=eng))
        ranc = ref_merge.merge_graphs(
            *pair.ref[:2], aln.mapping1, aln.mapping2, pair.ref[2],
            pair.ref[2], 0.4, 0.7, pair.ref_opts.replace(engine=eng))
        _same_graph(anc.graph, ranc.graph)
        assert list(anc.mapping1) == list(ranc.mapping1)
        assert list(anc.mapping2) == list(ranc.mapping2)
        assert list(anc.is_matched) == list(ranc.is_matched)


def test_offset_costs_rep(pair):
    for g, rg in zip(pair.port[:2], pair.ref[:2]):
        mine = slots.offset_costs_rep(g, pair.port[3], slots.MAX_OFF)
        theirs = ref_gdp._offset_costs_rep(rg, pair.ref[3], ref_gdp.MAX_OFF)
        for a, b in zip(mine, theirs):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    assert slots.offset_costs_rep(pair.port[0], pair.port[3], 0) is None
    for name in ("NEG", "COST_INF", "FLOOR", "BIG"):
        assert getattr(slots, name).tobytes() == \
            getattr(ref_gdp, name).tobytes(), name
    assert (slots.MAX_OFF, slots.TIERS, slots.EV_CAP) == \
        (ref_gdp.MAX_OFF, ref_gdp.TIERS, ref_gdp.EV_CAP)
    assert [slots.shb(op) for op, _ in slots.TIERS] == \
        [ref_gdp._shb(op) for op, _ in ref_gdp.TIERS]
    assert (slots.STATE_M, slots.STATE_X, slots.STATE_Y) == \
        (ref_bt.STATE_M, ref_bt.STATE_X, ref_bt.STATE_Y)


@pytest.mark.parametrize("distance", [0.05, 0.4, 1.7])
@pytest.mark.parametrize("name", ["WagModelFactory", "DarwinModelFactory",
                                  "EcmModelFactory"])
def test_model_factory(name, distance):
    mine = getattr(factory, name)().get_model(distance, Options())
    theirs = getattr(ref_factory, name)().get_model(distance, RefOptions())
    for k in ("M", "P", "Q", "pi"):
        assert np.array_equal(getattr(mine, k), getattr(theirs, k)), k
    for k in convert.MODEL_SCALARS:
        assert getattr(mine, k) == getattr(theirs, k), k


NEWICKS = ["tree0_fam6.nwk", "tree0_fam20.nwk", "tree_fam20.nwk",
           "W_tree_fam6.nwk"]


@pytest.mark.parametrize("name", NEWICKS)
def test_newick_parse_and_format(name):
    with open(G + "/" + name) as f:
        text = f.read()
    mine, theirs = newick.parse_newick(text), ref_newick.parse_newick(text)
    assert mine.format_newick() == theirs.format_newick()
    assert mine.format_newick() + "\n" == text or name.startswith("tree0")


def _fam20(mod_fasta, spec, path):
    """fam20, or its golden alignment with the gap code in gapped columns."""
    seqs, _ = mod_fasta.read_fasta(path)
    out = {}
    for n, s in seqs.items():
        col = np.array(list(s)) != "-"
        enc = np.full(len(s), spec.gap_code, dtype=np.int16)
        enc[col] = spec.encode(s.replace("-", ""))
        out[n] = enc
    return out


STAGES = ["angle", "angle_mldist", "prealigned", "nw", "tree_nj",
          "tree_nj_prealigned"]


@pytest.mark.parametrize("stage", STAGES)
def test_guide_tree_host_stages_on_fam20(stage):
    kw = dict(mldist_flag=True) if stage == "angle_mldist" else {}
    opts, ropts = Options(**kw), RefOptions(engine="native", **kw)
    spec, rspec = al.get_alphabet(opts), ref_al.get_alphabet(ropts)
    path = (G + "/c1_fam20.fasta" if "prealigned" in stage
            else FIX + "/fam20.fasta")
    seqs, rseqs = _fam20(fasta, spec, path), _fam20(ref_fasta, rspec, path)
    assert all(np.array_equal(seqs[n], rseqs[n]) for n in rseqs)
    order = sorted(seqs)
    vals = {n: spec.values(s) for n, s in seqs.items()}
    fac = factory.get_default_model_factory(opts, spec, vals)
    rfac = ref_factory.get_default_model_factory(ropts, rspec, vals)
    if stage.startswith("tree_nj"):
        flag = stage.endswith("prealigned")
        mine = treenj.tree_nj(spec, seqs, flag, fac, opts)
        theirs = ref_treenj.tree_nj(rspec, rseqs, flag, rfac, ropts)
        assert mine.format_newick() == theirs.format_newick()
        return
    if stage.startswith("angle"):
        mine = angle.compute_angle_distances(spec, seqs, order, opts)
        theirs = ref_angle.compute_angle_distances(rspec, rseqs, order,
                                                   ropts)
    elif stage == "prealigned":
        mine = pre.compute_prealigned_distances(spec, seqs, order, fac, opts)
        theirs = ref_pre.compute_prealigned_distances(rspec, rseqs, order,
                                                      rfac, ropts)
    else:
        mine = nw.compute_nw_distances(spec, seqs, order, fac, opts)
        theirs = ref_nw.compute_nw_distances(rspec, rseqs, order, rfac,
                                             ropts)
    for a, b in zip(mine, theirs):
        assert np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("name,flags", [
    ("fam20", dict(reroot_flag=1)),
    ("rep8", dict(reroot_flag=1)),
    ("rep8", dict(earlyref_flag=True))], ids=["fam20_r", "rep8_r", "rep8_er"])
def test_offset_costs_rep_on_the_slice_graphs(name, flags, monkeypatch):
    """Every graph that the root search or the refinement sends to the DP
    batch (cleaned merged graphs, uncleaned repeat graphs): the port's
    tables, built from the padded arrays, equal the JAX package's loop over
    the edge lists; on the repeat graphs also with an infinite repeat
    extension, whose one-unit repeat edges cost NaN (inf * 0)."""
    from types import SimpleNamespace

    from prographmsa_tpu_torch.engine import find_root, level_driver
    from test_torch_find_root import setup, stderr_of

    items = []
    orig = level_driver.align_items

    def recorded(its, *a):
        items.extend(its)
        return orig(its, *a)

    monkeypatch.setattr(level_driver, "align_items", recorded)
    spec, seqs, tree, reps, fac, opts = setup("prographmsa_tpu_torch", name,
                                              **flags)
    run = (find_root.progressive_alignment_find_root if opts.reroot_flag
           else level_driver.progressive_alignment_batched)
    stderr_of(run, spec, seqs, tree, reps, None, fac, opts, None)
    assert len(items) > 20
    n_reps = 0
    for g1, g2, _m, sc in items:
        for g in (g1, g2):
            scs = [sc]
            if any(g.reps):
                n_reps += 1
                scs.append(SimpleNamespace(repeat_init=sc.repeat_init,
                                           repeat_ext=np.float32(np.inf)))
            for s in scs:
                mine = slots.offset_costs_rep(g, s, slots.MAX_OFF)
                theirs = ref_gdp._offset_costs_rep(g, s, ref_gdp.MAX_OFF)
                assert (mine is None) == (theirs is None)
                if mine is not None:
                    for a, b in zip(mine, theirs):
                        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert (n_reps > 0) == (name == "rep8")
