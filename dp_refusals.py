#!/usr/bin/env python3
"""Which pairs of a run the card's DP batch would refuse, and why.

    python3 dp_refusals.py [--n N] [--seed S] [-- CLI ARGS]

Runs the port's CLI in this process on ``make_family(N, 300, AA, S)``
(as bench_torch.py makes fam1000; default N = 2000) with ``--engine
native --device cpu`` and the CLI ARGS (default: the default run, three
passes), and puts every item of every level batch through
``graph_dp_cuda.prep_pair`` as the card path would, before the host
aligns it.  Prints the count of each outcome (``ok`` or the fallback
counter's name) and, for each pair refused or with a side over 4,096
nodes, its node counts and the offset slots of each side (uncapped; the
card takes up to MAX_OFF).  Needs no card: prep_pair builds the slot
tables on the host.
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


def slot_count(graph, scores) -> int:
    """Offset slots of ``graph`` with no cap."""
    return len(slots._offset_costs_rep_numpy(graph, scores, 1 << 30)[0])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=2000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("cli_args", nargs="*")
    args = ap.parse_args(argv)
    tally, rows = collections.Counter(), []
    align_items = level_driver.align_items

    def tallied(items, *a, **k):
        for g1, g2, m, sc in items:
            p = gdp.prep_pair(0, g1, g2, m, sc)
            what = p if isinstance(p, str) else "ok"
            tally[what] += 1
            if what != "ok" or max(g1.size, g2.size) > 4096:
                rows.append((g1.size, g2.size, slot_count(g1, sc),
                             slot_count(g2, sc), what))
        return align_items(items, *a, **k)

    level_driver.align_items = tallied
    with tempfile.TemporaryDirectory(prefix="dp_refusals_") as tmp:
        fasta = os.path.join(tmp, "fam%d_seed%d.fasta" % (args.n, args.seed))
        mf = bt.make_fixtures()
        mf.write_fasta(fasta, mf.make_family(args.n, 300, bt.AA, args.seed))
        rc = cli.main(["--engine", "native", "--device", "cpu", "--fasta",
                       fasta, *args.cli_args, "-o",
                       os.path.join(tmp, "out.fasta")])
    print("outcomes: %s" % dict(tally))
    print("n1 n2 slots1 slots2 outcome (MAX_OFF %d)" % slots.MAX_OFF)
    for row in rows:
        print("%d %d %d %d %s" % row)
    return rc


if __name__ == "__main__":
    sys.exit(main())
