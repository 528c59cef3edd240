#!/usr/bin/env python3
"""The golden of the default run on a family of 1,000 (or ``--n``)
sequences, by the JAX package's CLI.

    JAX_PLATFORMS=cpu python3 prealigned_golden.py [--n N] [--seed S]
        [--check]
    python3 prealigned_golden.py --port [--n N] [--as-limit-kb KB]
        [--seed S] [-- CLI ARGS]

Runs ``prographmsa_tpu.cli --fasta FAMILY -o OUT`` in this process on the
CPU, with the CLI's defaults (``-i 2``: two re-trees from prealigned
distances), on ``make_family(N, 300, AA, S)``, made as bench_torch.py
makes fam1000, and writes ``fixtures/golden/fam<N>_seed<S>.fasta.gz``
(gzipped with mtime 0, as bench_goldens.py writes fam1000_i0's).
``--check`` writes nothing and exits 1 where the output differs from that
file.

The JAX package's host batch of pair statistics,
``prographmsa_tpu.distances.prealigned._pair_stats_batch_host``, builds
every (pair, column) array at once: at 1,000 rows, 499,500 pairs x 3,516
columns, over 50 GB.  For this run only it is replaced by a wrapper that
calls that same function over blocks of pairs (BLOCK_PAIR_COLUMNS
pair-columns each) and concatenates the counts and gap openings.  They are
exact integers, so the values are the function's own; no file of the JAX
package changes.  On the CPU the CLI's ``auto`` engine keeps the stage on
the host, so the wrapper computes every pair; the script exits 1 if it
was never called.  Prints the wall time, the peak RSS and the wrapper's
calls.  Takes about 8 minutes and 4 GB at 1,000 sequences.

``--port`` runs the port's CLI instead, ``python -m prographmsa_tpu_torch.cli
--fasta FAMILY -o OUT`` and the CLI ARGS after ``--`` (default ``--engine
native --device cpu --timings``), in a process of its own whose address
space is capped at ``--as-limit-kb`` (what ``ulimit -v`` sets; 0: no cap),
holds its output to the golden byte for byte (exit 1 where it differs) and
prints its wall time, its peak RSS and its ``--timings`` report.  It
imports no JAX.
"""

from __future__ import annotations

import argparse
import gzip
import os
import resource
import subprocess
import sys
import tempfile
import time

os.environ["JAX_PLATFORMS"] = "cpu"

import numpy as np  # noqa: E402

import bench_torch as bt  # noqa: E402

BLOCK_PAIR_COLUMNS = 1 << 24
N_SEQS, ROOT_LENGTH = 1000, 300


def golden_path(seed: int, n: int = N_SEQS) -> str:
    return os.path.join(bt.REPO, bt.GOLD, "fam%d_seed%d.fasta.gz" % (n, seed))


def write_input(path: str, seed: int, n: int = N_SEQS):
    mf = bt.make_fixtures()
    mf.write_fasta(path, mf.make_family(n, ROOT_LENGTH, bt.AA, seed))


def blocked(batch, calls):
    """``batch`` over blocks of pairs, the results concatenated."""
    def run(vmat, gmat, pi, pj, dim, count_bound):
        step = max(1, BLOCK_PAIR_COLUMNS // max(vmat.shape[1], 1))
        parts = [batch(vmat, gmat, pi[s:s + step], pj[s:s + step], dim,
                       count_bound) for s in range(0, len(pi), step)]
        calls.append((len(pi), len(parts)))
        return (np.concatenate([c for c, _ in parts]),
                np.concatenate([g for _, g in parts]))
    return run


def run_port(seed: int, as_limit_kb: int, cli_args, n: int = N_SEQS) -> int:
    """The port's CLI on the family in a capped process, against the
    golden."""
    def cap():
        if as_limit_kb:
            b = as_limit_kb * 1024
            resource.setrlimit(resource.RLIMIT_AS, (b, b))

    with tempfile.TemporaryDirectory(prefix="prealigned_golden_") as tmp:
        fasta = os.path.join(tmp, "fam%d_seed%d.fasta" % (n, seed))
        out = os.path.join(tmp, "out.fasta")
        write_input(fasta, seed, n)
        cmd = [sys.executable, "-m", "prographmsa_tpu_torch.cli", "--fasta",
               fasta, *cli_args, "-o", out]
        t0 = time.perf_counter()
        p = subprocess.run(cmd, cwd=bt.REPO, preexec_fn=cap,
                           capture_output=True, text=True)
        wall = time.perf_counter() - t0
        rss_gb = resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss / 1e6
        print(p.stderr, end="")
        print("port cli %s: exit %d, %.1f s, peak RSS %.3f GB, address "
              "space cap %s" % (" ".join(cli_args), p.returncode, wall,
                                rss_gb, "%d KB" % as_limit_kb if as_limit_kb
                                else "none"))
        if p.returncode != 0:
            return 1
        with open(out, "rb") as f:
            text = f.read()
    with gzip.open(golden_path(seed, n), "rb") as f:
        same = f.read() == text
    print("%s %s" % (golden_path(seed, n), "same" if same else "DIFFERS"))
    return 0 if same else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n", type=int, default=N_SEQS,
                    help="sequences in the family (default %(default)s)")
    ap.add_argument("--check", action="store_true",
                    help="compare with the golden in the repo, write none")
    ap.add_argument("--port", action="store_true",
                    help="run the port's CLI (no JAX) against the golden")
    ap.add_argument("--as-limit-kb", type=int, default=0,
                    help="with --port: cap the CLI's address space (KB)")
    ap.add_argument("cli_args", nargs="*", help="with --port, after --: "
                    "the port's CLI arguments")
    args = ap.parse_args(argv)
    if args.port:
        return run_port(args.seed, args.as_limit_kb, args.cli_args or [
            "--engine", "native", "--device", "cpu", "--timings"], args.n)

    import jax
    jax.config.update("jax_platforms", "cpu")
    from prographmsa_tpu import cli
    from prographmsa_tpu.distances import prealigned

    calls = []
    prealigned._pair_stats_batch_host = blocked(
        prealigned._pair_stats_batch_host, calls)
    with tempfile.TemporaryDirectory(prefix="prealigned_golden_") as tmp:
        fasta = os.path.join(tmp, "fam%d_seed%d.fasta" % (args.n, args.seed))
        out = os.path.join(tmp, "out.fasta")
        write_input(fasta, args.seed, args.n)
        t0 = time.perf_counter()
        rc = cli.main(["--fasta", fasta, "-o", out])
        wall = time.perf_counter() - t0
        rss_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
        print("jax cli: exit %d, %.1f s, peak RSS %.2f GB, host batch calls "
              "(pairs, blocks) %s" % (rc, wall, rss_gb, calls))
        if rc != 0 or not calls:
            print("error: the JAX CLI exited %d and called the host batch "
                  "%d times" % (rc, len(calls)), file=sys.stderr)
            return 1
        with open(out, "rb") as f:
            text = f.read()
    gold = golden_path(args.seed, args.n)
    if args.check:
        with gzip.open(gold, "rb") as f:
            same = f.read() == text
        print("%s %s" % (gold, "same" if same else "DIFFERS"))
        return 0 if same else 1
    with open(gold, "wb") as f:
        f.write(gzip.compress(text, mtime=0))
    print("wrote %s" % gold)
    return 0


if __name__ == "__main__":
    sys.exit(main())
