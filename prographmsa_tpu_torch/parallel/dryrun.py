"""Dry run of the port over a mesh of n shards: the counterpart of the
JAX package's ``__graft_entry__.dryrun_multichip``.

    python -m prographmsa_tpu_torch.parallel.dryrun [N] [--device cuda|cpu]

runs, on a mesh of N shards of ``--device`` (default: 4 shards of
``cuda:0``; shards may share a card):

1. S5 (``sharded.pipeline_step``): NW counts of 2N pairs, the Gram matrix
   and the +F histogram of 2N sequences, against the same work unsplit;
2. a level batch of real graph pairs (chains and a cleaned merged graph)
   through ``align_pairs_device`` over the mesh, mapping for mapping,
   score and n_tr_indels against the host ``fill_dp`` + ``backtrack``;
3. fam6 ``--mldist --nwdist`` through ``cli.do_align`` with the mesh,
   byte for byte against ``--engine native``, trees included.

With PROGRAPHMSA_DIST=1 each process brings N shards to the global mesh.
Prints ``dryrun(N): OK`` and exits 0, or raises.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from . import distributed
from .mesh import Mesh
from .sharded import pipeline_step

_FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..",
                    "fixtures")


def _step(mesh):
    from ..distances.align import GAP_PARAMS, _load_scoring
    from ..distances.nw_cuda import nw_counts

    scoring = _load_scoring("aa")
    go, ge = GAP_PARAMS["aa"]
    dim, B, L = 20, 2 * mesh.size, 16
    rng = np.random.default_rng(0)
    s1b = rng.integers(0, 20, (B, L)).astype(np.uint8)
    s2b = rng.integers(0, 20, (B, L)).astype(np.uint8)
    lens = np.full(B, L, np.int32)
    kmer = rng.integers(0, 3, (2 * mesh.size, 32)).astype(np.float32)
    values = rng.integers(-1, 20, (2 * mesh.size, 24)).astype(np.int32)
    counts, gaps, gram, hist = pipeline_step(mesh, s1b, s2b, lens, lens,
                                             scoring, go, ge, dim, kmer,
                                             values)
    dev = mesh.devices[0]
    t = lambda a: torch.from_numpy(a).to(dev)
    c0, g0 = nw_counts(t(s1b), t(s2b), t(lens), t(lens), t(scoring), go,
                       ge, dim)
    assert np.array_equal(counts, c0.cpu().numpy()), "S1 differs"
    assert np.array_equal(gaps, g0.cpu().numpy()), "S1 gaps differ"
    assert np.array_equal(gram, kmer @ kmer.T), "S3 differs"
    want = np.bincount(values[values >= 0], minlength=dim)
    assert np.array_equal(hist, want.astype(np.float32)), "S4 differs"


def _level_batch(mesh):
    from .. import checks
    from ..align.graph_dp_cuda import align_pairs_device

    m = checks.model(0.4)
    rng = np.random.default_rng(1)
    pairs = [(checks.chain(checks.random_seq(rng, 20)),
              checks.chain(checks.random_seq(rng, 18)), m)
             for _ in range(2 * mesh.size)]
    pairs.append((checks.merged("ACDEFGHIKLMNPQRSTVWY",
                                "ACDEFGIKMNPQRSTVWY", m),
                  checks.chain("ACDEFGHIKLMNPQRSTVW"), m))
    items, expected = checks.items_and_expected(pairs)
    res = align_pairs_device(items, mesh.devices[0], mesh)
    for k, (r, aln) in enumerate(zip(res, expected)):
        assert checks.same_alignment(r, aln), "level batch: pair %d" % k


def _fam6(mesh):
    from ..cli import do_align
    from ..config import Options
    from ..io.fasta import read_fasta

    fasta = os.path.join(_FIX, "fam6.fasta")
    seqs, _ = read_fasta(fasta)
    base = Options(sequence_file=fasta, mldist_flag=True, nwdist_flag=True,
                   fasta_flag=True, engine="native")
    got, trees = do_align(seqs, base, mesh.devices[0], "torch", mesh)
    want, trees_host = do_align(seqs, base, None, "native")
    assert got == want, "fam6 over the mesh differs from --engine native"
    assert ([t.format_newick() for t in trees]
            == [t.format_newick() for t in trees_host]), "fam6 trees differ"


def dryrun(mesh: Mesh) -> None:
    _step(mesh)
    _level_batch(mesh)
    _fam6(mesh)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", nargs="?", type=int, default=4)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    from ..device import resolve_device
    dev = resolve_device(args.device)
    if args.device == "cuda":
        dev = torch.device("cuda", 0)
    local = (dev,) * args.n
    mesh = (distributed.global_mesh(local)
            if distributed.maybe_initialize(dev) else Mesh(local))
    dryrun(mesh)
    print("dryrun(%d): OK" % mesh.size)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
