"""Graph-pair fixtures and host oracles for checking the port's kernels.

Shared by tests/test_torch_*.py (on the CPU, against the plain versions)
and chip_smoke.py (on the card, against the kernels).  Everything here is
host code of the port itself: the fixtures are the shapes of
tests/test_graph_dp_pallas.py (chains, merged graphs, heavy-offset graphs,
repeat-annotated chains), made from numpy seeds, and the oracles are the
port's own host tiers (``precompute_scores(engine="numpy")``, ``fill_dp`` +
``backtrack``, the native library).  The tests hold those against the JAX
package.
"""

from __future__ import annotations

import numpy as np

from .align.backtrack import backtrack
from .align.dp import fill_dp
from .align.merge import merge_graphs
from .align.scores import DynProgScores, precompute_scores
from .alphabet import AA_SPEC
from .config import Options
from .graph.graph import Graph, clean_graph, sequence_graph
from .models.factory import WagModelFactory

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
    """The native tier's fused C++ node alignment (None for repeat graphs)."""
    from . import native
    return native.align_node_native(g1, g2, m, sc)


def native_or_host(g1, g2, m, sc, host_aln):
    """The C++ result where the native tier takes the pair, else the
    Python host result."""
    aln = native_align(g1, g2, m, sc)
    return host_aln if aln is None else aln


def lanes_first_min(diffs, lanes: int):
    """The index X1's threads agree on for "first index at the minimal
    difference": thread l scans the candidates l, l + lanes, ... in order
    (the first one it meets is taken whatever its value, then strict
    improvement), and a butterfly keeps the smaller value and, at equal
    values, the smaller index (csrc/chase.cu: warp_first_min)."""
    none = np.iinfo(np.int32).max
    val = np.full(lanes, np.inf, np.float32)
    idx = np.full(lanes, none, np.int64)
    for k, d in enumerate(np.asarray(diffs, np.float32)):
        lane = k % lanes
        if idx[lane] == none or d < val[lane]:
            val[lane], idx[lane] = d, k
    off = lanes // 2
    while off:
        peer = np.arange(lanes) ^ off
        ov, oi = val[peer], idx[peer]
        take = (ov < val) | ((ov == val) & (oi < idx))
        val, idx = np.where(take, ov, val), np.where(take, oi, idx)
        off //= 2
    assert (idx == idx[0]).all()
    return int(idx[0])


def chase_window_model(fo, O1, O2, C1T, C2T, R1T, R2T, iv, par, Lm: int,
                       win: int, lanes: int = 32):
    """A scalar numpy model of kernel X1 (csrc/chase.cu) on CPU tensors: the
    same end transition and boundary replays split over ``lanes`` threads,
    and the same walk that reads codes only through a window of ``win`` x
    ``win`` cells ending at the cell it was last filled at, refilled when a
    step leaves it, and repeat flags through one mask of slots per node.
    Cells the kernel does not load are poisoned, so a read outside the
    window shows.  Returns (packed rows
    [B, row_width(Lm)] int32, stats [B, 3] int64: steps, window fills,
    boundary replays)."""
    from .align.chase_cuda import row_width
    from .align.slots import BIG, COST_INF, EV_CAP, NEG, STATE_M, STATE_X, STATE_Y

    f32 = np.float32
    a_ = lambda t: t.numpy()
    codes, ringM, ringY, ringX = a_(fo.codes), a_(fo.ringM), a_(fo.ringY), a_(fo.ringX)
    sYa, sXa = a_(fo.stripeY), a_(fo.stripeX)
    O1, O2, C1T, C2T, R1T, R2T, iv, par = (a_(t) for t in (O1, O2, C1T, C2T,
                                                            R1T, R2T, iv, par))
    B, D, n1max = codes.shape
    neg, big, cinf = f32(NEG), f32(BIG), f32(COST_INF)
    poison = -(1 << 30)
    out = np.zeros((B, row_width(Lm)), np.int64)
    stats = np.zeros((B, 3), np.int64)
    with np.errstate(over="ignore", invalid="ignore"):
        for b in range(B):
            n1, n2, nl1, nl2, R, shb = (int(v) for v in iv[b, :6])
            ge, gi, si, em, eg, es = (f32(par[b, k]) for k in (0, 1, 3, 4, 5, 6))
            smask = (1 << shb) - 1
            o1, o2, c1, c2, r1, r2 = O1[b], O2[b], C1T[b], C2T[b], R1T[b], R2T[b]
            cd, sY, sX = codes[b], sYa[b], sXa[b]
            dfull = n1 + n2 - 2

            def tail(ring, y, x):
                d = y + x
                if (y == 0 and x == 0) or d > dfull or d <= dfull - R:
                    return neg
                return ring[b, d % R, y]

            cands, valid = [], []
            for ab in range(nl1 * nl2):
                i, j = nl1 - 1 - ab // nl2, nl2 - 1 - ab % nl2
                yp, xp = n1 - 1 - int(o1[i]), n2 - 1 - int(o2[j])
                cy, cx = c1[i, n1 - 1], c2[j, n2 - 1]
                yc, xc = max(yp, 0), max(xp, 0)
                ok = yp >= 0 and xp >= 0 and cy < cinf and cx < cinf
                both0 = yp == 0 and xp == 0
                cands += [((tail(ringM, yc, xc) + em) - cy) - cx,
                          ((tail(ringY, yc, xc) + eg) - cy) - cx,
                          ((tail(ringX, yc, xc) + eg) - cy) - cx,
                          ((es - cy) - cx) if both0 else -big]
                valid += [ok, ok, ok, ok and both0]
            Wend = max([c for c, v in zip(cands, valid) if v], default=-big)
            Wend = f32(max(Wend, -big))
            kbest = lanes_first_min(
                [abs(f32(Wend - c)) if v else big
                 for c, v in zip(cands, valid)], lanes)
            t0, ab0 = kbest & 3, kbest >> 2
            i0, j0 = nl1 - 1 - ab0 // nl2, nl2 - 1 - ab0 % nl2
            y, x = max(n1 - 1 - int(o1[i0]), 0), max(n2 - 1 - int(o2[j0]), 0)
            st = (STATE_M, STATE_Y, STATE_X, STATE_X)[t0]
            if t0 == 3:
                y = x = 0
            m1, m2, ev = [], [], [[], [], [], []]
            fail_rep = fail_chase = False
            win_state = {}

            def push(v1, v2):
                m1.append(v1)
                m2.append(v2)

            def event(side, nxt, cur):
                nonlocal fail_rep
                if len(ev[0]) >= EV_CAP:
                    fail_rep = True
                    return
                for lst, v in zip(ev, (side, nxt, cur, len(m1))):
                    lst.append(v)

            def fill_window(yc, xc):
                yb, xb = yc - win + 1, xc - win + 1
                ylo, xlo = max(yb, 0), max(xb, 0)
                wcode = np.full((win, win), poison, np.int64)
                for yy in range(ylo, yc + 1):
                    for xx in range(xlo, xc + 1):
                        wcode[yy - yb, xx - xb] = cd[yy + xx, yy]
                win_state.update(yb=yb, xb=xb, wcode=wcode)
                stats[b, 1] += 1

            def code_at(yy, xx):
                w = win_state
                v = w["wcode"][yy - w["yb"], xx - w["xb"]]
                assert v != poison and yy >= w["yb"] and xx >= w["xb"]
                return int(v)

            def replay(pos, o, c, stripe, nl):
                cs = stripe[pos]
                diffs = []
                for a in range(nl):
                    k = nl - 1 - a
                    pb = pos - int(o[k])
                    ck, sv = c[k, pos], stripe[max(pb, 0)]
                    ok = pb >= 0 and ck < cinf
                    v_ext = neg if pb == 0 else sv
                    v_open = si if pb == 0 else sv
                    diffs += [abs(f32(cs - f32(f32(v_ext + ge) - ck))) if ok else big,
                              abs(f32(cs - f32(f32(v_open + gi) - ck))) if ok else big]
                stats[b, 2] += 1
                kB = lanes_first_min(diffs, lanes)
                return nl - 1 - (kB >> 1), kB & 1

            bits = lambda r, nl: [sum(int(r[k, at] != 0) << k
                                      for k in range(nl))
                                  for at in range(r.shape[1])]
            rm1, rm2 = bits(r1, nl1), bits(r2, nl2)
            push(n1 - 1, n2 - 1)
            if (rm1[n1 - 1] >> i0) & 1:
                event(1, y, n1 - 1)
            if (rm2[n2 - 1] >> j0) & 1:
                event(2, x, n2 - 1)
            if (x or y) and not fail_rep:
                push(-1 if st == STATE_X else y, -1 if st == STATE_Y else x)
            fill_window(y, x)
            code = code_at(y, x)
            it = 0
            while (y or x) and not fail_rep and it < Lm:
                isY, isX = st == STATE_Y, st == STATE_X
                i_sel, j_sel, rw = (code >> shb) & smask, code & smask, 1
                if isY:
                    if x == 0:
                        i_sel, rw = replay(y, o1, c1, sY, nl1)
                    else:
                        rw = (code >> (2 * shb)) & 1
                        i_sel = (code >> (2 * shb + 1)) & smask
                elif isX:
                    if y == 0:
                        j_sel, rw = replay(x, o2, c2, sX, nl2)
                    else:
                        rw = (code >> (3 * shb + 1)) & 1
                        j_sel = (code >> (3 * shb + 2)) & smask
                if (not isX and i_sel >= nl1) or (not isY and j_sel >= nl2):
                    fail_chase = True
                    break
                ny = y if isX else max(y - int(o1[i_sel]), 0)
                nx = x if isY else max(x - int(o2[j_sel]), 0)
                w = win_state
                if not isX and (rm1[y] >> i_sel) & 1:
                    event(1, ny, y)
                if not isY and (rm2[x] >> j_sel) & 1:
                    event(2, nx, x)
                if fail_rep:
                    break
                if ny < w["yb"] or nx < w["xb"]:
                    fill_window(ny, nx)
                code2 = code_at(ny, nx)
                nst = ((code2 >> (4 * shb + 2)) & 3) if rw == 1 else (
                    STATE_Y if isY else STATE_X)
                if ny or nx:
                    if len(m1) >= Lm - 1:
                        fail_chase = True
                        break
                    push(-1 if nst == STATE_X else ny,
                         -1 if nst == STATE_Y else nx)
                y, x, st, code = ny, nx, nst, code2
                it += 1
            if not fail_rep and (y or x):
                fail_chase = True
            if not fail_rep and not fail_chase:
                push(0, 0)
            stats[b, 0] = it
            row = out[b]
            row[:2 * Lm] = -2
            row[:len(m1)] = m1
            row[Lm:Lm + len(m2)] = m2
            row[2 * Lm:2 * Lm + 4] = (int(np.array(Wend, f32).view(np.int32)),
                                      len(m1), fail_rep, fail_chase)
            row[2 * Lm + 4] = len(ev[0])
            for r, lst in enumerate(ev):
                lo = 2 * Lm + 5 + r * EV_CAP
                row[lo:lo + len(lst)] = lst
    return out.astype(np.int32), stats


S_OWNERS = ("none", "cell", "masked", "neg_group", "neg_tile")


def s_tile_model(plan, dim: int, n1max: int, n2max: int, n1, n2, S=None):
    """A numpy model of how kernel K2 (csrc/scores.cu: s_kernel) walks its
    tiles under ``plan`` (scores_cuda.SPlan) for pairs of n1[b] x n2[b]
    nodes and ``dim`` states padded to n1max x n2max: the same grid, the same test for a tile
    wholly outside a pair's band, the same per-warp test for a group of
    diagonals without a cell, the same window columns.  Returns
    (owners [B, D, n1max]: how many threads store to each position of
    Sdiag; kinds [B, D, n1max]: an index into S_OWNERS saying what the last
    of them stored, a band cell, a masked position of a group with cells,
    NEG of a group without, NEG of a tile outside the band; Sdiag assembled
    that way from the planes ``S`` [b][n1, n2], or None).  Raises if a
    thread reads a window column the block's ``plan.smem_bytes`` do not
    hold, or keeps a cell whose column the window fill left out."""
    from .align.scores_cuda import S_CHAINS, S_FIXED_DIMS, s_col_floats
    from .align.slots import NEG

    TY, DT, CH = plan.threads, plan.dtile, S_CHAINS
    B, D = len(n1), n1max + n2max - 1
    if plan.grid != (-(-n1max // TY), -(-D // DT), B):
        raise AssertionError("grid %s for %d x %d" % (plan.grid, n1max, n2max))
    owners = np.zeros((B, D, n1max), np.int32)
    kinds = np.zeros((B, D, n1max), np.int8)
    Sd = None if S is None else np.full((B, D, n1max), np.nan, np.float32)
    g1_tile = 0 if dim in S_FIXED_DIMS else dim * TY
    cols = (plan.smem_bytes // 4 - g1_tile) // s_col_floats(dim)
    lane = np.arange(32)

    def store(b, d, y, kind, val=None):
        np.add.at(owners, (b, d, y), 1)
        kinds[b, d, y] = kind
        if Sd is not None:
            Sd[b, d, y] = NEG if val is None else val

    for b in range(B):
        n1b, n2b = int(n1[b]), int(n2[b])
        for by in range(plan.grid[1]):
            for bx in range(plan.grid[0]):
                y0, d0 = bx * TY, by * DT
                dte, rows = min(DT, D - d0), min(TY, n1max - y0)
                ylast = min(y0 + TY, n1b) - 1
                if y0 >= n1b or d0 + dte - 1 - y0 < 0 or d0 - ylast >= n2b:
                    dd, yy = np.meshgrid(np.arange(d0, d0 + dte),
                                         np.arange(y0, y0 + rows))
                    store(b, dd.ravel(), yy.ravel(), 4)
                    continue
                xlo = d0 - y0 - (TY - 1)
                xs = xlo + np.arange(TY - 1 + dte)
                filled = (xs >= 0) & (xs < min(n2b, n2max))
                for warp in range(TY // 32):
                    t = warp * 32 + lane
                    y, row = y0 + t, t < rows
                    yw = y0 + warp * 32
                    jlo = yw - d0
                    jhi = (min(yw + 31, n1b - 1) - d0 + n2b - 1
                           if yw < n1b else -1)
                    for j in range(0, dte, CH):
                        ji = j + np.arange(CH)
                        st = row[:, None] & (ji < dte)[None, :]
                        dd = np.broadcast_to(d0 + ji[None, :], st.shape)
                        yy = np.broadcast_to(y[:, None], st.shape)
                        if j + CH - 1 < jlo or j > jhi:
                            store(b, dd[st], yy[st], 3)
                            continue
                        col = (TY - 1 - t)[:, None] + ji[None, :]
                        # columns the fill wrote (copied or zeroed)
                        written = TY - 1 + -(-dte // CH) * CH
                        if col.min() < 0 or col.max() >= min(cols, written):
                            raise AssertionError("column %d..%d of %d"
                                                 % (col.min(), col.max(), cols))
                        x = dd - yy
                        cell = (yy < n1b) & (x >= 0) & (x < n2b) & st
                        if not (xlo + col == x).all():
                            raise AssertionError("window column is not x")
                        if not (col[cell] < len(xs)).all() \
                                or not filled[col[cell]].all():
                            raise AssertionError("a cell's column was not "
                                                 "filled")
                        store(b, dd[cell], yy[cell], 1,
                              None if S is None else S[b][yy[cell], x[cell]])
                        store(b, dd[st & ~cell], yy[st & ~cell], 2)
    return owners, kinds, Sd


_M32 = 0xFFFFFFFF


def pair_pack_model(vals, gapm, cb):
    """Kernel D1's pack of an alignment (vals [N, L] int, gapm [N, L]):
    G, K [N, W] uint32 (bit b of word q is column 32 q + b: gapped, and
    counted, i.e. not gapped with the value in [0, cb); padding columns
    >= L are gapped) and C [N, 32 W] uint8 (the value where counted)."""
    N, L = vals.shape
    W = -(-L // 32)
    g = np.ones((N, 32 * W), bool)
    g[:, :L] = np.asarray(gapm) != 0
    v = np.zeros((N, 32 * W), np.int64)
    v[:, :L] = vals
    k = ~g & (v >= 0) & (v < cb)
    bit = np.uint64(1) << np.arange(32, dtype=np.uint64)

    def words(b):
        return (b.reshape(N, W, 32) * bit).sum(-1).astype(np.uint32)

    return words(g), words(k), np.where(k, v, 0).astype(np.uint8)


def _side_opens(s, t, cin):
    """One side's gap openings over a word of kernel D1 (the carry in and
    out are the state "the last non-transparent column was gapped on this
    side"): (openings, carry out)."""
    a = ((s << 1) | cin) & t & _M32
    e = (s | (t & ~(t + a))) & _M32
    return bin(s & ~((e << 1) | cin) & _M32).count("1"), e >> 31


def pair_stats_word_model(G, K, C, pi, pj, cb):
    """Kernel D1's statistics launch on packed rows (pair_pack_model), as
    its warp runs a pair: lane l owns words [l R, l R + R), R = ceil(W /
    32); each lane scans its words with carry in 0, noting whether its run
    has a non-transparent column and the sides of the first one, and walks
    the set bits of Ki & Kj into the histogram; three ballots give each
    lane the carry out of the nearest lower lane with a non-transparent
    column, which corrects the first column's opening.  Returns counts
    [P, cb, cb] and gaps [P], int64."""
    P, W = len(pi), G.shape[1]
    run = -(-W // 32)
    counts = np.zeros((P, cb, cb), np.int64)
    gaps = np.zeros(P, np.int64)
    for p in range(P):
        i, j = int(pi[p]), int(pj[p])
        lanes = []
        for lane in range(32):
            cx = cy = fx = fy = opens = 0
            seen = False
            for q in range(lane * run, min(lane * run + run, W)):
                gi, gj = int(G[i, q]), int(G[j, q])
                t, x, y = gi & gj, gi & ~gj & _M32, gj & ~gi & _M32
                ox, cx = _side_opens(x, t, cx)
                oy, cy = _side_opens(y, t, cy)
                opens += ox + oy
                nt = ~t & _M32
                low = nt & -nt
                if not seen:
                    fx, fy, seen = x & low, y & low, nt != 0
                m = int(K[i, q]) & int(K[j, q])
                while m:
                    c = q * 32 + (m & -m).bit_length() - 1
                    m &= m - 1
                    counts[p, C[i, c], C[j, c]] += 1
            lanes.append((seen, cx, cy, fx, fy, opens))
        ballot = [sum(int(bool(r[f])) << lane for lane, r in enumerate(lanes))
                  for f in range(3)]
        for lane, (_, _, _, fx, fy, opens) in enumerate(lanes):
            below = ballot[0] & ((1 << lane) - 1)
            if below:
                s = below.bit_length() - 1
                opens -= int((ballot[1] >> s) & 1 and fx != 0)
                opens -= int((ballot[2] >> s) & 1 and fy != 0)
            gaps[p] += opens
    return counts, gaps


def pair_lane_loads(K, pi, pj):
    """Counted columns (set bits of Ki & Kj) a lane of kernel D1 walks, per
    pair and lane under its runs of ceil(W / 32) words: [P, 32] int64, and
    per pair the bits of the lanes' fullest word summed over the words of a
    run (what a warp pays when the lanes walk each word in step):
    [P] int64."""
    P, W = len(pi), K.shape[1]
    run = -(-W // 32)
    m = np.zeros((P, 32 * run), np.uint32)
    m[:, :W] = K[pi] & K[pj]
    bits = np.bitwise_count(m).astype(np.int64).reshape(P, 32, run)
    return bits.sum(2), bits.max(1).sum(1)


# the synthetic alignments D1 is held on: values in [0, hi), of which those
# >= cb are never counted (the AA X, DNA N, the codons beyond 20)
PAIR_ALPHABETS = {"aa": (21, 20), "dna": (5, 4), "codon": (61, 20)}
PAIR_MASKS = ("runs_across_words", "lane_boundary", "transparent_lanes",
              "all_gap_rows", "x_residues")


def pair_stats_msa(alpha, mask, seed=0, N=8, L=2061):
    """(vals [N, L] int32, gapm [N, L] uint8, cb) of one synthetic
    alignment for kernel D1.  Lanes own 96 columns at L = 2061 (W = 65, 3
    words a lane, 22 lanes busy).  Masks: columns gapped in every row
    (transparent) over runs that cross 1, 2 and 3 word boundaries, or a
    lane boundary, or the whole of lane 1 and of lanes 3-4 (the carry
    passes through them); around each run every third row is gapped just
    before and just after it, so the carry decides an opening; all-gap
    rows; residues never counted (>= cb, and -1).  Gapped columns hold
    random values too."""
    hi, cb = PAIR_ALPHABETS[alpha]
    rng = np.random.default_rng([seed, list(PAIR_ALPHABETS).index(alpha),
                                 PAIR_MASKS.index(mask)])
    top = hi if alpha == "codon" or mask == "x_residues" else cb
    vals = rng.integers(0, top, (N, L))
    gap = rng.random((N, L)) < 0.3
    runs = {"runs_across_words": [(20, 50), (250, 300), (90, 170)],
            "lane_boundary": [(80, 110), (180, 200), (1900, 1950)],
            "transparent_lanes": [(96, 192), (288, 480)]}.get(mask, [])
    for a, b in runs:
        gap[:, a:b] = True
        for c in (a - 1, b):
            gap[:, c] = np.arange(N) % 3 == 0
    if mask == "all_gap_rows":
        gap[1] = gap[4] = True
    if mask == "x_residues":
        vals[rng.random((N, L)) < 0.3] = hi
        vals[rng.random((N, L)) < 0.05] = -1
    return vals.astype(np.int32), gap.astype(np.uint8), cb


# lengths at the edges of D2's strips (32, 64 or 128 rows) and its chunks of
# 16 steps (the first chunk a lane runs without a test starts at step 32)
NW_STRIP_N2 = (1, 31, 63, 64, 65, 129)
NW_STRIP_N1 = (0, 1, 31, 32, 47, 80)


def nw_strip_edge_pairs(rng, copies: int):
    """(s1, s2, l1, l2): every (n1, n2) of NW_STRIP_N1 x NW_STRIP_N2,
    ``copies`` times, random codes < 21 (uint8)."""
    l1, l2 = (np.tile(a.ravel(), copies).astype(np.int32)
              for a in np.meshgrid(NW_STRIP_N1, NW_STRIP_N2))
    return (rng.integers(0, 21, (len(l1), max(NW_STRIP_N1))).astype(np.uint8),
            rng.integers(0, 21, (len(l2), max(NW_STRIP_N2))).astype(np.uint8),
            l1, l2)


def nw_strip_rows(n2: int, R: int):
    """D2's strips of a pair of n2 rows at up to ``R`` rows a lane, as
    (first row y0, rows a lane): strips of 32 R rows while more than 16 R
    rows are left, then one of 64 rows (R = 4 only) or 32 rows for the
    rest."""
    strips, y0 = [], 1
    while y0 <= n2:
        left = n2 - y0 + 1
        Rs = 4 if R >= 4 and left > 64 else 2 if R >= 2 and left > 32 else 1
        strips.append((y0, Rs))
        y0 += 32 * Rs
    return strips


def nw_strip_of(y: int, n2: int, R: int):
    """(y0, rows a lane) of the strip of ``nw_strip_rows(n2, R)`` that
    holds row y, in closed form as the kernel's walk finds it: the strips
    of 32 R rows hold the first tb rows, the one after them the rest."""
    S = 32 * R
    tb = -(-(n2 - S // 2) // S) * S if n2 > S // 2 else 0
    if y - 1 < tb:
        return (y - 1) // S * S + 1, R
    return tb + 1, 2 if R >= 4 and n2 - tb > 32 else 1


def nw_warp_model(s1, s2, scoring, go: int, ge: int, dim: int, R: int = 1):
    """One pair of kernel D2 as the warp runs it, with up to ``R`` rows a
    lane: the strips of ``nw_strip_rows``; in a strip of Rs rows a lane, at
    step s lane l takes column x = s - l for its Rs rows, top to bottom
    (the first gets the row above from lane l - 1 of the step before, lane
    0 from the row buffer that lane 31 refills for 0 <= x <= n1; the others
    from the row before in registers); the score from the strip's int8
    profile (one word a code and lane, byte r for row r); W from two DPX
    maxima whose predicates are the backtrack bits (pd: W is the diagonal,
    px: X >= Y); steps in chunks of 16, the steady chunks (every lane live)
    without a test, the ramp-in (steps 0 .. 31) with x < 1 left as it was,
    the ramp-out running the cells right of n1 on unchecked; a
    word a row and chunk, keyed by step, stored at the chunk's end, a strip
    from row y0 at word (y0 - 1) words laid out [chunk, row of the strip];
    then the walk back, which finds (y, x) at step x + lane.  Returns
    (counts [dim, dim], gaps)."""
    MINF = -10000
    n1, n2 = len(s1), len(s2)
    words = (n1 + 47) // 16
    bits = np.zeros(-(-n2 // (32 * R)) * 32 * R * words, np.int64)
    rowW = np.array([0] + [go + (x - 1) * ge for x in range(1, n1 + 1)])
    rowY = np.full(n1 + 1, MINF)
    lanes = np.arange(32)
    strips = nw_strip_rows(n2, R) if n1 else []
    for y0, Rs in strips:
        S = 32 * Rs
        y = y0 + lanes[:, None] * Rs + np.arange(Rs)[None, :]   # [32, Rs]
        yc = np.minimum(y, n2) - 1
        sc8 = np.where((y <= n2)[..., None], scoring[np.asarray(s2)[yc]],
                       0).astype(np.int64) & 0xff               # [32,Rs,T]
        prof = (sc8 << (8 * np.arange(Rs))[None, :, None]).sum(1).T
        W = go + (y - 1) * ge
        X = np.full((32, Rs), MINF)
        Y = W.copy()
        dg0 = np.zeros(32, np.int64)
        base = (y0 - 1) * words
        for k in range((n1 + 31) // 16 + 1):
            steady = 16 * k >= 32 and 16 * k + 15 <= n1
            acc = np.zeros((32, Rs), np.int64)
            for s in range(16 * k, 16 * k + 16):
                x = s - lanes
                live = (x >= 1) & (x <= n1)
                inr = (x >= 0) & (x <= n1)
                assert not steady or live.all()
                upW = np.roll(W[:, Rs - 1], 1)         # lane - 1's last row
                upY = np.roll(Y[:, Rs - 1], 1)
                upW[0] = rowW[min(max(x[0], 0), n1)]
                upY[0] = rowY[min(max(x[0], 0), n1)]
                p = prof[np.asarray(s1)[np.clip(x - 1, 0, n1 - 1)], lanes]
                dg, dg0 = dg0, np.where(inr, upW, dg0)
                for r in range(Rs):
                    b = (p >> (8 * r)) & 0xff
                    d = dg + np.where(b >= 128, b - 256, b)
                    Xn = np.maximum(X[:, r] + ge, W[:, r] + go)
                    Yn = np.maximum(upY + ge, upW + go)
                    m = np.maximum(Xn, Yn)
                    Wn = np.maximum(d, m)
                    acc[:, r] |= ((d >= m).astype(np.int64)
                                  | ((Xn >= Yn).astype(np.int64) << 1)) \
                        << (2 * (s & 15))
                    dg = W[:, r].copy()
                    keep = ~live & (k < 2)     # the ramp-out runs on
                    W[:, r] = np.where(keep, W[:, r], Wn)
                    X[:, r] = np.where(keep, X[:, r], Xn)
                    Y[:, r] = np.where(keep, Y[:, r], Yn)
                    upW, upY = Wn, Yn
                if inr[31]:
                    rowW[x[31]], rowY[x[31]] = W[31, Rs - 1], Y[31, Rs - 1]
            bits[base + k * S:base + (k + 1) * S] = acc.reshape(-1)
    counts = np.zeros((dim, dim), np.int64)
    y, x, gaps, go1, go2 = n2, n1, 0, False, False
    while y > 0 and x > 0:
        y0, Rs = nw_strip_of(y, n2, R)
        i = y - y0
        s = x + i // Rs
        wd = bits[(y0 - 1) * words + s // 16 * 32 * Rs + i]
        b = (wd >> (2 * (s & 15))) & 3
        if b & 1:
            if s1[x - 1] < dim and s2[y - 1] < dim:
                counts[s1[x - 1], s2[y - 1]] += 1
            go1 = go2 = False
            x, y = x - 1, y - 1
        elif b & 2:
            gaps += not go1
            go1, go2 = True, False
            x -= 1
        else:
            gaps += not go2
            go1, go2 = False, True
            y -= 1
    return counts, gaps
