#!/usr/bin/env python3
"""The CLI's default run of a family of N sequences on the port's tiers,
each in a process of its own, with every stage, the peak host RSS and
torch's peak card memory.

    python3 default_run.py --n 4000 [--tiers card,native] [--parent DIR]
        [--seed S] [--out DIR]

Writes ``make_family(N, 300, AA, S)`` (as bench_torch.py makes fam1000)
and runs ``python -m prographmsa_tpu_torch.cli --fasta FAMILY --timings``
(the default: ``-i 2``, two re-trees from prealigned distances) on each
tier: ``card`` (the defaults, ``--engine torch --device cuda``) and
``native`` (``--engine native --device cpu``, no torch).  With ``--parent
DIR`` each tier runs the tree at DIR, this tree, this tree again and DIR
again, in that order (a paired order: the host drifts within a call).
Each run goes through chip_smoke.py's ``memory_run``: its peak RSS
sampled from /proc, its children's (the first guide tree's process), its
launches and torch's peak card memory.  Every output must be byte for byte
the same as every other, and as ``fixtures/golden/fam<N>_seed<S>.fasta.gz``
where that file exists (prealigned_golden.py --n N); the script exits 1
otherwise.  Prints one line a run: the wall, every ``--timings`` phase,
the ``torch_*`` counters, the memory; the stderr of each run goes to
``<tier>_<tree>_<k>.stderr`` in ``--out`` (default ``default_run`` in
chip_smoke.py's gitignored output directory); the family and the outputs
stay in a temporary directory.  Needs no card for ``--tiers native``.
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import re
import sys
import tempfile

import bench_torch as bt
import chip_smoke as cs

TIERS = {"card": (), "native": ("--engine", "native", "--device", "cpu")}


def phases_of(err):
    """Every phase of a --timings report: {name: seconds}."""
    return {m.group(1): float(m.group(2)) for m in re.finditer(
        r"^\s+([a-z_0-9]+)\s+([0-9.]+) s", err, re.M)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tiers", default="card,native")
    ap.add_argument("--parent", help="a checkout of another tree")
    ap.add_argument("--out", default=os.path.join(cs.OUT, "default_run"))
    args = ap.parse_args(argv)
    out = os.path.abspath(args.out)
    os.makedirs(out, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="default_run_") as tmp:
        return run_all(args, out, tmp)


def run_all(args, out, tmp) -> int:
    """Every run of ``args``' tiers and trees on the family written into
    ``tmp`` (the outputs too: tens of MB at 4,000); each run's stderr into
    ``out``."""
    fasta = os.path.join(tmp, "fam%d_seed%d.fasta" % (args.n, args.seed))
    mf = bt.make_fixtures()
    mf.write_fasta(fasta, mf.make_family(args.n, 300, bt.AA, args.seed))
    gold_path = os.path.join(cs.GOLD, "fam%d_seed%d.fasta.gz"
                             % (args.n, args.seed))
    gold = None
    if os.path.exists(gold_path):
        with gzip.open(gold_path, "rb") as f:
            gold = f.read()
    parent = args.parent and os.path.abspath(args.parent)
    trees = ([("parent", parent), ("change", cs.REPO), ("change", cs.REPO),
              ("parent", parent)] if parent else [("change", cs.REPO)])
    first, ok = None, True
    for tier in args.tiers.split(","):
        for k, (name, tree) in enumerate(trees):
            stem = "%s_%s_%d" % (tier, name, k)
            wall, rec, err = cs.memory_run(tree, fasta,
                                           os.path.join(tmp, stem + ".fasta"),
                                           TIERS[tier], limit_s=2400)
            with open(os.path.join(out, stem + ".stderr"), "w") as f:
                f.write(err)
            with open(os.path.join(tmp, stem + ".fasta"), "rb") as f:
                text = f.read()
            os.remove(os.path.join(tmp, stem + ".fasta"))
            first = text if first is None else first
            same = text == first and (gold is None or text == gold)
            ok &= same
            ctr = {k_: v for k_, v in (cs.counters_of(err) if "counters:"
                                       in err else {}).items()
                   if k_.startswith("torch_")}
            gb = lambda b: None if b is None else round(b / 1e9, 3)
            print("%s %s wall_s=%.3f same=%s golden=%s phases=%s "
                  "counters=%s host_rss_gb=%s tree_rss_gb=%s "
                  "card_allocated_gb=%s card_reserved_gb=%s" % (
                      tier, name, wall, same,
                      "none" if gold is None else text == gold,
                      json.dumps(phases_of(err), separators=(",", ":")),
                      json.dumps(ctr, separators=(",", ":")),
                      gb(rec["host_rss_bytes"]), gb(rec["tree_rss_bytes"]),
                      gb(rec["card_allocated_bytes"]),
                      gb(rec["card_reserved_bytes"])), flush=True)
    if not ok:
        print("error: the outputs differ%s" % (
            "" if gold is None else " or differ from " + gold_path),
            file=sys.stderr)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
