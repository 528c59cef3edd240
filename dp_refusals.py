#!/usr/bin/env python3
"""Which pairs of a run the card's DP batch would refuse, and why.

    python3 dp_refusals.py [--n N] [--seed S] [--fasta FILE] [-- CLI ARGS]

Runs the port's CLI in this process on ``make_family(N, 300, AA, S)``
(as bench_torch.py makes fam1000; default N = 2000), or on FILE, with
``--engine native --device cpu`` and the CLI ARGS (default: the default
run, three passes), and puts every item of every level batch through
``graph_dp_cuda.prep_pair`` as the card path would, before the host
aligns it.  Prints the count of each outcome (``ok`` or the fallback
counter's name) and, for each pair that breaks a rule under either set
of limits below or has a side over 4,096 nodes: its node counts, each
side's offset slots (uncapped) and largest offset, its reach R (the two
largest offsets + 2, the ring diagonals K3 keeps), the code width it
needs (``shb`` bits; int32 words up to 64 slots, int64 up to 255), every
rule it breaks under the limits before 8-bit code fields (64 slots a
side, rings of at most 256 diagonals: the JAX package's tiers) and under
today's (``prep_pair``: 255 slots a side, ``launch_fits`` at the pair's
code width and reach), and its outcome.  Also cuts each batch's ``ok``
pairs into launches as the card path does on one card
(``graph_dp_cuda._launches``) and prints their count, the wide ones',
the largest ring bytes that ``launch_fits`` leaves out of LAUNCH_BYTES
(K3's four ring planes of a launch whose reach is within NEAR_R) beside
that launch's counted planes, and the count of launches were the rings
counted at every reach.  Needs no card: prep_pair
builds the slot tables on the host.
"""

from __future__ import annotations

import argparse
import collections
import os
import sys
import tempfile

import bench_torch as bt
from prographmsa_tpu_torch import cli
from prographmsa_tpu_torch.align import graph_dp_cuda as gdp
from prographmsa_tpu_torch.align import slots
from prographmsa_tpu_torch.engine import level_driver

OLD_MAX_OFF = 64         # slots a side before 8-bit code fields
OLD_MAX_R = 256          # ring diagonals before any reach was taken


def slot_offsets(graph, scores):
    """Offsets of ``graph``'s slots with no cap."""
    return slots._offset_costs_rep_numpy(graph, scores, 1 << 30)[0]


def census_row(g1, g2, scores, outcome):
    """(n1, n2, slots1, off1, slots2, off2, R, width, old rules, new
    rules, outcome) of one pair."""
    o1, o2 = slot_offsets(g1, scores), slot_offsets(g2, scores)
    k, R = max(len(o1), len(o2)), int(o1.max()) + int(o2.max()) + 2
    n1, n2, dim = g1.size, g2.size, g1.dim
    old, new = [], []
    if not gdp.launch_fits(1, n1, n2, dim):
        old.append("fb_size")
        new.append("fb_size")
    if k > OLD_MAX_OFF:
        old.append("fb_offsets")
    if R > OLD_MAX_R:
        old.append("fb_reach")
    if k > slots.MAX_OFF:
        new.append("fb_offsets")
    elif not new and not gdp.launch_fits(1, n1, n2, dim, k, R):
        new.append("fb_reach" if gdp.launch_fits(1, n1, n2, dim, k)
                   else "fb_size")
    width = ("%d-bit/%s" % (slots.shb(k), "int64" if slots.wide(k)
                            else "int32") if k <= slots.MAX_OFF else "none")
    return (n1, n2, len(o1), int(o1.max()), len(o2), int(o2.max()), R,
            width, ",".join(old) or "-", ",".join(new) or "-", outcome)


def launch_census(preps, acc):
    """Add one batch's launches to ``acc``: their count, the wide ones',
    the launch whose uncounted rings are the largest (ring bytes, plane
    bytes, pairs) and the count with every launch's rings counted."""
    near = gdp.NEAR_R
    try:
        gdp.NEAR_R = 0
        gdp.launch_fits.cache_clear()
        acc["launches_all_rings"] += len(gdp._launches(preps))
    finally:
        gdp.NEAR_R = near
        gdp.launch_fits.cache_clear()
    for chunk in gdp._launches(preps):
        B, op = len(chunk), max(gdp.slots_of(p) for p in chunk)
        n1 = -(-max(p.g1.size for p in chunk) // 8) * 8
        n2 = max(p.g2.size for p in chunk)
        R = max(p.R for p in chunk)
        acc["launches"] += 1
        acc["wide"] += slots.wide(op)
        rings = B * 4 * 4 * R * n1
        if R <= gdp.NEAR_R and rings > acc["rings"][0]:
            planes = B * (n1 + n2) * n1 * (4 + (8 if slots.wide(op) else 4))
            acc["rings"] = (rings, planes, B)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=2000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fasta", help="this input instead of make_family's")
    ap.add_argument("cli_args", nargs="*")
    args = ap.parse_args(argv)
    tally, rows = collections.Counter(), []
    acc = {"launches": 0, "wide": 0, "rings": (0, 0, 0),
           "launches_all_rings": 0}
    align_items = level_driver.align_items

    def tallied(items, *a, **k):
        preps = []
        for g1, g2, m, sc in items:
            p = gdp.prep_pair(0, g1, g2, m, sc)
            what = p if isinstance(p, str) else "ok"
            tally[what] += 1
            if what == "ok":
                preps.append(p)
            row = census_row(g1, g2, sc, what)
            if (row[8], row[9]) != ("-", "-") or max(g1.size, g2.size) > 4096:
                rows.append(row)
        launch_census(preps, acc)
        return align_items(items, *a, **k)

    level_driver.align_items = tallied
    with tempfile.TemporaryDirectory(prefix="dp_refusals_") as tmp:
        fasta = args.fasta
        if fasta is None:
            fasta = os.path.join(tmp, "fam%d_seed%d.fasta"
                                 % (args.n, args.seed))
            mf = bt.make_fixtures()
            mf.write_fasta(fasta, mf.make_family(args.n, 300, bt.AA,
                                                 args.seed))
        rc = cli.main(["--engine", "native", "--device", "cpu", "--fasta",
                       fasta, *args.cli_args, "-o",
                       os.path.join(tmp, "out.fasta")])
    print("outcomes: %s" % dict(tally))
    print("launches: %d (wide %d; %d with the rings counted at every "
          "reach); largest rings left out of LAUNCH_BYTES (reach <= NEAR_R "
          "%d): %d bytes beside %d bytes of planes, %d pairs"
          % (acc["launches"], acc["wide"], acc["launches_all_rings"],
             gdp.NEAR_R, *acc["rings"]))
    print("n1 n2 slots1 off1 slots2 off2 R width rules_old rules_new "
          "outcome (old: %d slots, R %d; new: MAX_OFF %d, launch_fits)"
          % (OLD_MAX_OFF, OLD_MAX_R, slots.MAX_OFF))
    for row in rows:
        print("%d %d %d %d %d %d %d %s %s %s %s" % row)
    return rc


if __name__ == "__main__":
    sys.exit(main())
