"""Graph-pair fixtures and host oracles for checking the port's kernels.

Shared by tests/test_torch_*.py (on the CPU, against the plain versions)
and chip_smoke.py (on the card, against the kernels).  Everything here is
host code: the fixtures are the shapes of tests/test_graph_dp_pallas.py
(chains, merged graphs, heavy-offset graphs, repeat-annotated chains), made
from numpy seeds, and the oracles are the reference's host tiers
(``precompute_scores(engine="numpy")``, ``fill_dp`` + ``backtrack``).
"""

from __future__ import annotations

import numpy as np

from prographmsa_tpu.align.backtrack import backtrack
from prographmsa_tpu.align.dp import fill_dp
from prographmsa_tpu.align.merge import merge_graphs
from prographmsa_tpu.align.scores import DynProgScores, precompute_scores
from prographmsa_tpu.alphabet import AA_SPEC
from prographmsa_tpu.config import Options
from prographmsa_tpu.graph.graph import Graph, clean_graph, sequence_graph
from prographmsa_tpu.models.factory import WagModelFactory

OPTS = Options(engine="native")
REPEAT_OPTS = Options(engine="native", repeat_rate=0.5, repeatext_prob=0.3)
FACTORY = WagModelFactory()
AAS = list("ACDEFGHIKLMNPQRSTVWY")


def model(distance: float, opts=OPTS):
    return FACTORY.get_model(distance, opts)


def chain(seq: str) -> Graph:
    return sequence_graph(AA_SPEC, AA_SPEC.encode(seq))


def random_seq(rng, n: int) -> str:
    return "".join(rng.choice(AAS, n))


def host_align(g1, g2, m, opts=OPTS):
    """(AlignmentResult, DynProgScores) from the numpy S, fill_dp and the
    Python backtrack."""
    sc = DynProgScores(g1, g2, m, opts)
    S = precompute_scores(g1, g2, m, sc, engine="numpy")
    return backtrack(g1, g2, fill_dp(g1, g2, S, sc), sc), sc


def merged(s1: str, s2: str, m) -> Graph:
    """The cleaned ancestral graph of two aligned chains (multi-offset)."""
    g1, g2 = chain(s1), chain(s2)
    aln, _ = host_align(g1, g2, m)
    anc = merge_graphs(g1, g2, aln.mapping1, aln.mapping2, m, m, 0.5, 0.5,
                       OPTS)
    return clean_graph(anc.graph, OPTS)[0]


def mutated(rng, s: str, n_del: int, p_sub: float = 0.1) -> str:
    chars = list(s)
    for k in sorted(rng.choice(len(chars), n_del, replace=False),
                    reverse=True):
        del chars[k]
    return "".join(rng.choice(AAS) if rng.rand() < p_sub else c
                   for c in chars)


def heavy(n: int, offsets, seed: int) -> Graph:
    """A chain of n nodes with extra edges at the given offsets (many
    distinct predecessor offsets per graph)."""
    r = np.random.RandomState(seed)
    g = chain(random_seq(r, n - 2))
    preds = [list(p) for p in g.preds]
    for i in range(2, n - 1):
        for o in offsets:
            if i - o >= 1 and r.rand() < 0.3:
                preds[i].append((i - o, np.float32(0.25 * o)))
    for p in preds:
        p.sort(key=lambda t: t[0])
    return Graph(g.sites.copy(), preds, [list(x) for x in g.reps])


def repeat_pair(seed: int):
    """A repeat-annotated chain against a chain with fewer units, as in the
    reference's repeat fuzz; returns (g1, g2, model) under REPEAT_OPTS."""
    rng = np.random.RandomState(100 + seed)
    unit = random_seq(rng, rng.randint(3, 6))
    reps = rng.randint(2, 5)
    pre = random_seq(rng, rng.randint(0, 8))
    post = random_seq(rng, rng.randint(0, 8))
    g1 = chain(pre + unit * reps + post)
    tr = np.full(g1.size, -1, dtype=np.int64)
    lo = len(pre) + 1
    tr[lo:lo + len(unit) * reps] = np.tile(np.arange(len(unit)), reps)
    g1.add_repeats([tr])
    g2 = chain(pre + unit * max(1, reps - rng.randint(1, reps)) + post)
    return g1, g2, model(0.3 + 0.1 * seed, REPEAT_OPTS)


def fixed_repeat_pair():
    """The reference's fixed repeat-splice case (takes a repeat edge)."""
    g1 = chain("ACDEFACDEFACDEF")
    tr = np.full(g1.size, -1, dtype=np.int64)
    tr[1:16] = np.tile(np.arange(5), 3)
    g1.add_repeats([tr])
    return g1, chain("ACDEFACDEF"), model(0.3, REPEAT_OPTS)


def many_offsets_graph(n: int, n_offsets: int, seed: int) -> Graph:
    """More than 16 distinct offsets: the 6-bit code-field layout."""
    return heavy(n, list(range(2, 2 + n_offsets)), seed)


def items_and_expected(pairs, opts=OPTS):
    """[(g1, g2, m)] -> (items for align_pairs_device, host results)."""
    items, expected = [], []
    for g1, g2, m in pairs:
        aln, sc = host_align(g1, g2, m, opts)
        items.append((g1, g2, m, sc))
        expected.append(aln)
    return items, expected


def same_alignment(res, aln) -> bool:
    """Mappings, float32 score and n_tr_indels equal the host result."""
    return (res is not None and list(res[0]) == list(aln.mapping1)
            and list(res[1]) == list(aln.mapping2)
            and np.float32(res[2]) == np.float32(aln.score)
            and res[3] == aln.n_tr_indels)


def native_align(g1, g2, m, sc):
    """The reference's fused C++ node alignment (None for repeat graphs)."""
    from prographmsa_tpu import native
    return native.align_node_native(g1, g2, m, sc)


def native_or_host(g1, g2, m, sc, host_aln):
    """The C++ result where the native tier takes the pair, else the
    Python host result."""
    aln = native_align(g1, g2, m, sc)
    return host_aln if aln is None else aln
