"""The ``dist`` diagnostic tool of the PyTorch/CUDA port: pairwise distance
estimators side by side (the port's counterpart of
prographmsa_tpu/dist_cli.py, after the reference's dist.cpp).

  python -m prographmsa_tpu_torch.dist_cli [-w] [-F] [-C N] \\
      [--engine torch|device|auto|native] [--device cuda|cpu] seqs.fasta

For every sequence pair it prints

    p_dist  angle_dist  alignml_dist  p_var  angle_var  alignml_var

where p = NW-alignment counts without ML refinement, angle = k-mer cosine
distance, alignml = NW counts + ML Newton refinement.  The NW counts run
where ``--engine`` sends them (kernel D2 on ``--device`` under ``torch``,
the default); the angle distances where it sends the Gram.

Parity quirks reproduced:
* dist.cpp never initializes the numeric cmdlineopts fields, so min/max
  clamps and cutoff_dist are ZERO (global zero-initialization) — the two
  alignment-based estimates clamp to 0 (dist.cpp:25, main.h:37-82).
* pseudocount default is 1125, not the main tool's 1000 (dist.cpp:46).
* sequences are not stripped of initial Met (dist.cpp:84).
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

from .alphabet import AA_SPEC
from .config import Options
from .engine_policy import ENGINES, engine_device, use_device_angle
from .io.fasta import read_fasta
from .models.factory import (DarwinModelFactory, PlusFModelFactory,
                             WagModelFactory)


def _zeroed_options(**kw) -> Options:
    """An Options struct with every numeric field zero-initialized,
    mirroring dist.cpp's never-assigned global cmdlineopts."""
    zeros = {}
    for f in dataclasses.fields(Options):
        if f.type in ("float", float):
            zeros[f.name] = 0.0
        elif f.type in ("int", int) and not f.name.endswith("_flag"):
            zeros[f.name] = 0
    zeros.update(kw)
    return Options(**zeros)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="ProGraphMSA-Torch-dist")
    p.add_argument("sequences")
    p.add_argument("-o", "--output", default="")
    p.add_argument("-w", "--darwin", action="store_true")
    p.add_argument("-F", "--estimate_aafreqs", action="store_true")
    p.add_argument("-C", "--aafreqs_pseudocount", type=float, default=1125.0)
    p.add_argument("--engine", choices=ENGINES, default="torch",
                   help="where the NW counts and the angle Gram run "
                   "(engine_policy.py)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="torch device of the engine's card stages")
    args = p.parse_args(argv)

    try:
        device = engine_device(args.engine, args.device)
    except RuntimeError as e:
        print("error: %s" % e, file=sys.stderr)
        return 2

    opts = _zeroed_options(pseudo_count=args.aafreqs_pseudocount,
                           darwin_flag=args.darwin,
                           aafreqs_flag=args.estimate_aafreqs)

    seqs_str, _ = read_fasta(args.sequences)
    seqs = {n: AA_SPEC.encode(s) for n, s in seqs_str.items()}
    order = sorted(seqs)

    factory = DarwinModelFactory() if args.darwin else WagModelFactory()
    if args.estimate_aafreqs:
        factory = PlusFModelFactory(factory, opts)
        factory.estimate_freqs([AA_SPEC.values(seqs[n]) for n in order],
                               opts)

    from .distances.align import compute_nw_distances
    from .distances.angle import (compute_angle_distances,
                                  compute_angle_distances_device)

    opts_ml = dataclasses.replace(opts, mldist_flag=True)
    dp, vp = compute_nw_distances(AA_SPEC, seqs, order, factory, opts,
                                  device, args.engine)
    da, va = compute_nw_distances(AA_SPEC, seqs, order, factory, opts_ml,
                                  device, args.engine)
    if use_device_angle(args.engine):
        dg, vg = compute_angle_distances_device(AA_SPEC, seqs, order,
                                                opts_ml, device)
    else:
        dg, vg = compute_angle_distances(AA_SPEC, seqs, order, opts_ml)

    out = open(args.output, "w") if args.output else sys.stdout
    try:
        n = len(order)
        for i in range(n):
            for j in range(i + 1, n):
                out.write("%g\t%g\t%g\t%g\t%g\t%g\n" % (
                    dp[i, j], dg[i, j], da[i, j],
                    vp[i, j], vg[i, j], va[i, j]))
    finally:
        if args.output:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
