"""Command line of the PyTorch/CUDA port: the flags and orchestration of
the reference binary (main.cpp:32-483), as prographmsa_tpu/cli.py has them,
with the graph-pair DP of every progressive pass on the port's device batch.

  python -m prographmsa_tpu_torch.cli [reference flags] \\
      [--engine torch|native] [--device cuda|cpu] sequences.fasta

``--engine torch`` (default) runs each guide-tree level's DP batch on
``--device`` (default ``cuda``, which must exist: there is no silent CPU
run; ``cpu`` runs the kernels' plain PyTorch versions).  ``--engine native``
keeps the DP on the port's own C++ host tier.  The guide-tree distances
run on the host in both.  ``-r`` and ``--early_refinement`` are not ported
yet and exit with an error.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict

import numpy as np

from . import alphabet as al
from . import timings
from .config import Options
from .engine_policy import ENGINES, use_torch_dp
from .errors import ParityError
from .io.fasta import FastaError, read_fasta, write_fasta
from .io.newick import parse_newick
from .io.stockholm import write_stockholm
from .models.factory import get_default_model_factory
from .tree.phytree import get_tree_order
from .tree.treenj import tree_nj

NOT_PORTED = {
    "reroot": "-r/--reroot",
    "early_refinement": "--early_refinement",
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ProGraphMSA-Torch",
        description="ProGraphMSA, fast multiple sequence alignment "
                    "(PyTorch/CUDA port)")
    a = p.add_argument
    a("sequences", help="input sequences (fasta file)")
    a("-o", "--output", default="", help="Output file name")
    a("-t", "--tree", default="", help="initial guide tree (newick file)")
    a("--topology", default="", help="topology of initial guide tree")
    a("--codon", action="store_true")
    a("--dna", action="store_true")
    a("-f", "--fasta", action="store_true",
      help="output fasta format (instead of stockholm)")
    a("-g", "--indel_rate", type=float, default=0.0093359375)
    a("-e", "--gap_ext", type=float, default=0.6119140625)
    a("-E", "--end_indel_prob", type=float, default=0.12)
    a("-l", "--edge_halflife", type=float, default=0.3)
    a("-s", "--altsplice_prob", type=float, default=0.328125)
    a("-x", "--cutoff_dist", type=float, default=2.2)
    a("-d", "--min_dist", type=float, default=0.05)
    a("-D", "--max_dist", type=float, default=2.2)
    a("-p", "--min_pdist", type=float, default=0.05)
    a("-P", "--max_pdist", type=float, default=0.8)
    a("-A", "--no_force_align", action="store_true")
    a("--repeat_indel_rate", type=float, default=0.1)
    a("--repeat_indel_ext", type=float, default=0.3)
    a("--repalign", action="store_true")
    a("-R", "--repeats", action="count", default=0)
    a("--read_repeats", default="")
    a("--trd_output", default="")
    a("--custom_tr_cmd", default="")
    a("-r", "--reroot", action="count", default=0)
    a("-W", "--wls_refine", action="count", default=0)
    a("--early_refinement", action="store_true")
    a("-c", "--cs_profile", default="")
    a("-w", "--darwin", action="store_true")
    a("--profile_out", default="")
    a("--custom_model", default="")
    a("-F", "--estimate_aafreqs", action="store_true")
    a("-C", "--aafreqs_pseudocount", type=float, default=1000.0)
    a("-a", "--nwdist", action="store_true")
    a("-m", "--mldist", action="store_true")
    a("-M", "--mldist_gap", action="store_true")
    a("-I", "--input_order", action="store_true")
    a("-T", "--only_tree", action="store_true")
    a("-i", "--iterations", type=int, default=None)
    a("--all_trees", action="store_true")
    a("--ancestral_seqs", action="store_true")
    # extension (not a reference flag): per-phase wall-clock report to stderr
    a("--timings", action="store_true", dest="timings")
    # extension (not a reference flag): phase checkpoint/resume directory
    a("--checkpoint_dir", default="")
    # extensions (not reference flags): DP engine and its torch device
    a("--engine", choices=ENGINES, default="torch",
      help="DP engine: torch = the port's device batch on --device; "
      "native = the C++ host tier")
    a("--device", choices=("cuda", "cpu"), default="cuda",
      help="torch device of the DP batch (cuda must exist)")
    return p


def options_from_args(args) -> Options:
    iters = args.iterations
    if iters is None:
        iters = 0 if args.tree else 2
    opt = Options(
        output_file=args.output, sequence_file=args.sequences,
        tree_file=args.tree, topo_file=args.topology,
        cs_file=args.cs_profile, cmodel_file=args.custom_model,
        readreps_file=args.read_repeats, trdout_file=args.trd_output,
        profile_file=args.profile_out, customtr_cmd=args.custom_tr_cmd,
        iters=iters, reroot_flag=args.reroot, wlsrefine_flag=args.wls_refine,
        earlyref_flag=args.early_refinement, repeats_flag=args.repeats,
        repalign_flag=args.repalign, fasta_flag=args.fasta,
        noforcealign_flag=args.no_force_align,
        aafreqs_flag=args.estimate_aafreqs, darwin_flag=args.darwin,
        nwdist_flag=args.nwdist, onlytree_flag=args.only_tree,
        mldist_flag=args.mldist, mldist_gap_flag=args.mldist_gap,
        alltrees_flag=args.all_trees, ancestral_flag=args.ancestral_seqs,
        codon_flag=args.codon, dna_flag=args.dna,
        inputorder_flag=args.input_order,
        indel_rate=args.indel_rate, end_indel_prob=args.end_indel_prob,
        gapext_prob=args.gap_ext, edge_halflife=args.edge_halflife,
        altsplice_prob=args.altsplice_prob,
        pseudo_count=args.aafreqs_pseudocount, cutoff_dist=args.cutoff_dist,
        repeat_rate=args.repeat_indel_rate,
        repeatext_prob=args.repeat_indel_ext,
        max_dist=args.max_dist, min_dist=args.min_dist,
        max_pdist=args.max_pdist, min_pdist=args.min_pdist,
        engine=args.engine,
        timings_flag=args.timings,
        checkpoint_dir=args.checkpoint_dir,
    )
    # codon default rescaling (main.cpp:225-241): only when flags unset
    defaults = dict(indel_set="--indel_rate" in sys.argv or "-g" in sys.argv,
                    edgehl_set="--edge_halflife" in sys.argv or "-l" in sys.argv,
                    maxdist_set="--max_dist" in sys.argv or "-D" in sys.argv,
                    cutdist_set="--cutoff_dist" in sys.argv or "-x" in sys.argv)
    return opt.with_codon_rescaling(**defaults)


def do_align(seqs: Dict[str, str], options, device):
    """doAlign<ALPHABET> (main.cpp:324-483) over the port's level driver.
    ``options`` carries ``engine="native"`` for the host layers; ``device``
    is the DP batch's torch device, or None for the host DP.

    Returns (aligned {name: str}, all_trees [PhyTree])."""
    from .engine.level_driver import progressive_alignment_batched

    spec = al.get_alphabet(options)

    # strip start/stop codons (main.cpp:326-353)
    any_start_stripped = any_end_stripped = False
    start_stripped, end_stripped = {}, {}
    seqs2: Dict[str, np.ndarray] = {}
    for name in seqs:
        enc = spec.encode(seqs[name])
        start_stripped[name] = end_stripped[name] = False
        if not options.noforcealign_flag:
            if spec.strip_start is not None and len(enc):
                if enc[0] == spec.encode(spec.strip_start)[0]:
                    enc = enc[1:]
                    any_start_stripped = start_stripped[name] = True
            if spec.strip_end is not None and len(enc):
                if spec.name == "codon" and enc[-1] == al.CODON_X:
                    enc = enc[:-1]
                    any_end_stripped = end_stripped[name] = True
        seqs2[name] = enc

    seqs_values = {n: spec.values(s) for n, s in seqs2.items()}
    factory = get_default_model_factory(options, spec, seqs_values)

    csprofile = None
    if options.cs_file:
        from .cs_profile import CSProfileLibrary
        csprofile = CSProfileLibrary(options.cs_file)

    reps: Dict[str, list] = {}
    if options.readreps_file:
        from .repeats_treks import read_repeats
        reps = read_repeats(options.readreps_file, seqs2, spec)
    elif options.repeats_flag:
        from .repeats_treks import align_repeats, detect_repeats
        reps = detect_repeats(seqs2, spec, options)
        if options.repalign_flag:
            reps = align_repeats(seqs2, reps, csprofile, factory, options,
                                 spec)

    topo = None
    if options.topo_file:
        with open(options.topo_file) as fh:
            topo = parse_newick(fh.read())
    ckpt = state = None
    if options.checkpoint_dir:
        from .checkpoint import PhaseCheckpoint
        ckpt = PhaseCheckpoint(options, seqs)
        state = ckpt.load()

    if state is not None:
        tree = state["tree"]
        all_trees = state["all_trees"]
        old_aligned = state["old_aligned"]
        start_i = state["i_next"]
    else:
        if options.tree_file:
            with open(options.tree_file) as fh:
                tree = parse_newick(fh.read())
        else:
            tree = tree_nj(spec, seqs2, False, factory, options, topo)
        all_trees = [tree.copy()]
        old_aligned = None
        start_i = 0
        if ckpt is not None:
            ckpt.save(0, tree, all_trees, None)

    def _progressive(tr):
        if csprofile is not None and spec.name == "aa":
            with timings.phase("cs_profile"):
                leaves = []

                def _walk(node):
                    if node.is_leaf():
                        leaves.append((seqs2[node.name],
                                       factory.get_model(node.branch_length,
                                                         options)))
                        return
                    for ci in range(node.n_children()):
                        _walk(node[ci])

                _walk(tr)
                csprofile.prime_profiles(leaves)
        return progressive_alignment_batched(spec, seqs2, tr, reps,
                                             csprofile, factory, options,
                                             device)

    result = None
    for i in range(start_i, options.iters):
        result = _progressive(tree)
        # delete ancestral sequences (main.cpp:408-416)
        result.aligned_sequences = {
            n: s for n, s in result.aligned_sequences.items()
            if not n.startswith("(")}
        # early convergence exit (main.cpp:418-420)
        if i > 0 and _aligned_equal(result.aligned_sequences, old_aligned):
            break
        tree = tree_nj(spec, result.aligned_sequences, True, factory,
                       options, topo)
        all_trees.append(tree.copy())
        old_aligned = result.aligned_sequences
        if ckpt is not None:
            ckpt.save(i + 1, tree, all_trees, old_aligned)

    if not options.onlytree_flag:
        result = _progressive(tree)

    if options.repeats_flag:
        # with -T the reference prints the default-constructed count
        n_tr = result.n_tr_indels if result is not None else 0
        print("TR indels: %d" % n_tr, file=sys.stderr)

    if options.profile_file and result is not None:
        from .io.profile_out import write_profile
        with open(options.profile_file, "w") as fh:
            write_profile(result.profiles, fh)

    aligned: Dict[str, str] = {}
    if result is not None:
        for name, aseq in result.aligned_sequences.items():
            aseq = np.asarray(aseq, dtype=np.int16)
            if any_start_stripped:
                code = (spec.x_code if start_stripped.get(name)
                        else spec.gap_code)
                aseq = np.concatenate([[code], aseq]).astype(np.int16)
            if any_end_stripped:
                code = (spec.x_code if end_stripped.get(name)
                        else spec.gap_code)
                aseq = np.concatenate([aseq, [code]]).astype(np.int16)
            aligned[name] = (al.string_from_sequence(spec, aseq, seqs[name])
                             if name in seqs
                             else al.string_from_sequence(spec, aseq))
    return aligned, all_trees


def _aligned_equal(a, b) -> bool:
    if b is None or set(a) != set(b):
        return False
    return all(np.array_equal(a[k], b[k]) for k in a)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    for dest, flag in NOT_PORTED.items():
        if getattr(args, dest):
            print("error: %s is not ported to the torch package yet "
                  "(ROADMAP.md, modules still to port: -r find-root and "
                  "--early_refinement on the device DP)" % flag,
                  file=sys.stderr)
            return 2
    port_options = options_from_args(args)
    options = port_options.replace(engine="native")
    device = None
    if use_torch_dp(port_options):
        from .device import resolve_device
        try:
            device = resolve_device(args.device)
        except RuntimeError as e:
            print("error: %s" % e, file=sys.stderr)
            return 2

    if options.timings_flag:
        timings.enable(True)

    try:
        seqs, input_order = read_fasta(options.sequence_file)
        aligned, all_trees = do_align(seqs, options, device)
        if options.timings_flag:
            timings.report(sys.stderr)

        out = (open(options.output_file, "w") if options.output_file
               else sys.stdout)
        try:
            if not options.onlytree_flag:
                order = input_order
                if not options.inputorder_flag:
                    order = get_tree_order(all_trees[-1], options)
                if options.fasta_flag:
                    write_fasta(aligned, order, out)
                else:
                    write_stockholm(
                        aligned, order, all_trees[-1], out,
                        all_trees if options.alltrees_flag else None)
            elif options.alltrees_flag:
                for t in all_trees:
                    out.write(t.format_newick() + "\n")
            else:
                out.write(all_trees[-1].format_newick() + "\n")
        finally:
            if options.output_file:
                out.close()
    except (FastaError, ParityError) as e:
        # the reference's error() -> "error: msg" + abort() (status 134)
        print("error: %s" % e, file=sys.stderr)
        return 134
    except Exception as e:  # noqa: BLE001  (parity: main.cpp:315-319)
        print("ERROR:%s" % e, file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
