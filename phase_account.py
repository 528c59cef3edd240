"""One cell's wall and ``--timings`` phases per tier and pool size, this
tree beside another's, each run a process of its own.

    python3 phase_account.py [--parent DIR] [--threads 1,default]
                             [--tiers card,native] [--golden FILE]
                             [--out FILE] [CLI_ARGS...]

CLI_ARGS are the port CLI's own; the default is fam500's root search,
``--fasta -r -i 0 fixtures/fam500.fasta``, held to
``fixtures/golden/fam500_r_i0.fasta``.  For each pool size (``N`` sets
``PROGRAPHMSA_THREADS=N``; ``default`` leaves the variable unset: the
cores; a list may repeat sizes, for runs in turn) and each
tier (``card``: ``--engine torch --device cuda``; ``native``: ``--engine
native --device cpu``), the CLI runs from DIR (a checkout of another tree,
e.g. a ``git archive`` of the parent unpacked into the gitignored
``_parent/``) and then from this tree, so the two alternate.  Each
tree's native library, and for the card tier its kernels, are built
first, in a process of their own.  Every output is held to the golden.
Prints one JSON line per run (tree, tier, threads, wall from spawn to
exit, every phase of its ``--timings`` report: ``clean``, ``dp_fused``,
``merge`` and ``extend`` are wall time on the scheduler's thread in a
tree with the native batches, sums over the pool's threads in a tree
before them), then the card's name and
power limit as ``nvidia-smi`` gives them; ``--out`` also writes the runs
to FILE as one JSON list.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
DEFAULT = ["--fasta", "-r", "-i", "0",
           os.path.join(REPO, "fixtures", "fam500.fasta")]
DEFAULT_GOLDEN = os.path.join(REPO, "fixtures", "golden",
                              "fam500_r_i0.fasta")
BUILD = """from prographmsa_tpu_torch import _build, native
native.lib()
if %s:
    _build.lib()"""
TIERS = {"card": ["--engine", "torch", "--device", "cuda"],
         "native": ["--engine", "native", "--device", "cpu"]}


def phases_of(err):
    """Seconds of each phase of a ``--timings`` report."""
    return {m.group(1): float(m.group(2)) for m in re.finditer(
        r"^  (\S+)\s+([0-9.]+) s", err, re.M)}


def run(tree, tier, threads, cli_args, out):
    env = dict(os.environ)
    env.pop("PROGRAPHMSA_THREADS", None)
    if threads != "default":
        env["PROGRAPHMSA_THREADS"] = threads
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-m", "prographmsa_tpu_torch.cli",
                        *cli_args, *TIERS[tier], "--timings", "-o", out],
                       cwd=tree, env=env, capture_output=True, text=True,
                       timeout=3000)
    wall = time.perf_counter() - t0
    if p.returncode != 0:
        raise SystemExit("phase_account: %s at %s exited %d: %s"
                         % (tier, tree, p.returncode, p.stderr[-3000:]))
    return {"wall_s": wall, **phases_of(p.stderr)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent")
    ap.add_argument("--threads", default="1,default")
    ap.add_argument("--tiers", default="card,native")
    ap.add_argument("--golden")
    ap.add_argument("--out")
    args, cli_args = ap.parse_known_args()
    if not cli_args:
        cli_args, args.golden = DEFAULT, args.golden or DEFAULT_GOLDEN
    trees = ([("parent", os.path.abspath(args.parent))] if args.parent
             else []) + [("change", REPO)]
    gold = None
    if args.golden:
        with open(args.golden) as f:
            gold = f.read()
    out = os.path.join(REPO, "chiprun_out", "phase_account.fasta")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tiers = args.tiers.split(",")
    for _, tree in trees:      # no build inside a timed run
        subprocess.run([sys.executable, "-c", BUILD % ("card" in tiers)],
                       cwd=tree, check=True, timeout=900)
    runs = []
    for threads in args.threads.split(","):
        for tier in tiers:
            for name, tree in trees:
                r = dict(tree=name, tier=tier, threads=threads,
                         **run(tree, tier, threads, cli_args, out))
                if gold is not None:
                    with open(out) as f:
                        if f.read() != gold:
                            raise SystemExit("phase_account: %s %s differs "
                                             "from %s" % (name, tier,
                                                          args.golden))
                print(json.dumps(r), flush=True)
                runs.append(r)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(runs, f, indent=1)
    try:
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60).stdout.strip())
    except OSError:
        print("no nvidia-smi")


if __name__ == "__main__":
    main()
