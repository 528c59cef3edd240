#!/usr/bin/env python3
"""Times the native BioNJ (``native.bionj_native``) on a random D and V at
each size and thread count, in a fresh process of each tree, in turns.

    python3 bionj_time.py [--n 2000,4000] [--threads 1,8] [--parent DIR]
        [--torch] [--reps 1]

Each measurement is one process (``python -c``, the working directory the
tree's root, ``PROGRAPHMSA_THREADS`` set): it builds the tree's native
library if need be, makes D and V from ``numpy.random.default_rng(n)``
(symmetric, uniform; V a tenth), calls ``bionj_native`` once untimed at
n = 64 and then once timed, and prints the seconds and a digest of the
joins, lengths and last D.  With ``--torch`` the process first imports
torch and makes a CUDA context, as a card run's process has before its
re-trees.  With ``--parent DIR`` the tree at DIR runs before and after
this one's two runs (parent, change, change, parent) at each size and
thread count; every digest at a size must be the same (exit 1).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.abspath(__file__))

SNIPPET = r"""
import hashlib, os, sys, time
import numpy as np
if sys.argv[2] == "1":
    import torch
    torch.zeros(1, device="cuda")
from prographmsa_tpu_torch import native
assert native.lib() is not None, "no native library"
n = int(sys.argv[1])
def dv(n):
    rng = np.random.default_rng(n)
    a, b = rng.random((n, n)), rng.random((n, n)) * 0.1
    return a + a.T, b + b.T
native.bionj_native(*dv(64), [])
D, V = dv(n)
t0 = time.perf_counter()
out = native.bionj_native(D, V, [])
s = time.perf_counter() - t0
h = hashlib.sha256(b"".join(a.tobytes() for a in out)).hexdigest()[:16]
print("%.4f %s" % (s, h))
"""


def run(tree, n, threads, torch_first):
    env = dict(os.environ, PROGRAPHMSA_THREADS=str(threads))
    p = subprocess.run([sys.executable, "-c", SNIPPET, str(n),
                        "1" if torch_first else "0"], cwd=tree, env=env,
                       capture_output=True, text=True, timeout=3600)
    if p.returncode != 0:
        raise SystemExit("bionj_time: %s failed: %s" % (tree,
                                                         p.stderr[-2000:]))
    sec, digest = p.stdout.split()
    return float(sec), digest


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", default="2000")
    ap.add_argument("--threads", default="1,8")
    ap.add_argument("--parent", help="a checkout of another tree")
    ap.add_argument("--torch", action="store_true",
                    help="import torch and make a CUDA context first")
    ap.add_argument("--reps", type=int, default=1)
    args = ap.parse_args(argv)
    order = ([("parent", args.parent), ("change", REPO), ("change", REPO),
              ("parent", args.parent)] if args.parent else [("change", REPO)])
    ok = True
    for n in map(int, args.n.split(",")):
        digests = set()
        for t in map(int, args.threads.split(",")):
            for _ in range(args.reps):
                for name, tree in order:
                    sec, digest = run(tree, n, t, args.torch)
                    digests.add(digest)
                    print("n=%d threads=%d %s %.4f s %s%s" % (
                        n, t, name, sec, digest,
                        " after torch" if args.torch else ""), flush=True)
        if len(digests) != 1:
            print("error: n=%d gave %d different results" % (n, len(digests)),
                  file=sys.stderr)
            ok = False
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
