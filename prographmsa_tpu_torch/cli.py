"""Command line of the PyTorch/CUDA port: the flags and orchestration of
the reference binary (main.cpp:32-483), as prographmsa_tpu/cli.py has them,
with the graph-pair DP of every progressive pass, of the root search and of
the early refinement on the port's device batch.

  python -m prographmsa_tpu_torch.cli [reference flags] \\
      [--engine torch|device|auto|native] [--device cuda|cpu] sequences.fasta

``--engine`` routes each stage (the table in engine_policy.py):
``torch`` (default) runs every level's DP batch, the NW distances
(``--nwdist``) and the prealigned statistics of each re-tree on
``--device``, and keeps the float64 stages (angle Gram, CS mix) on the
host; ``device`` also runs those two on the card in float32; ``auto``
chooses per level and per stage from a probed calibration of the card;
``native`` keeps everything on the port's C++ host tier.  ``--device``
defaults to ``cuda``, which must exist: there is no silent CPU run
(``cpu`` runs the kernels' plain PyTorch versions; ``auto`` calibrates
the card and needs ``cuda``).  The root search (``-r``, ``-r -r``,
engine/find_root.py) and ``--early_refinement`` (in the level scheduler)
send their alignments through the same DP batch, wave by wave.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict

import numpy as np

from . import alphabet as al
from . import first_tree, timings
from .config import Options
from .engine_policy import ENGINES, engine_device
from .errors import ParityError
from .inputs import encode_input, model_factory, read_topology
from .io.fasta import FastaError, parse_fasta, read_text, write_fasta
from .io.newick import parse_newick
from .io.stockholm import write_stockholm
from .tree.phytree import get_tree_order
from .tree.treenj import tree_nj

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
    # extensions (not reference flags): engine policy and its torch device
    a("--engine", choices=ENGINES, default="torch",
      help="torch = DP batch, NW and prealigned statistics on --device, "
      "float64 stages on the host; device = also the angle Gram and CS mix "
      "in float32; auto = per level and stage from a probed calibration; "
      "native = the C++ host tier")
    a("--device", choices=("cuda", "cpu"), default="cuda",
      help="torch device of the engine's card stages (cuda must exist)")
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


def do_align(seqs: Dict[str, str], options, device, engine: str = "torch",
             mesh=None, apart=None):
    """doAlign<ALPHABET> (main.cpp:324-483) over the port's level driver.
    ``options`` carries ``engine="native"`` for the host layers; ``engine``
    is the port's engine policy and ``device`` the torch device of its card
    stages, or None with ``native``.  First joins the process group when
    PROGRAPHMSA_DIST=1 (parallel/distributed.py).  ``mesh`` splits the DP
    batches (levels, root search, refinement) and the NW distances over its
    shards; None takes ``engine_policy.level_mesh(device)``, which is None
    on one card outside a process group.  ``apart``, a started
    ``first_tree.Apart``, gives the first guide tree.

    Returns (aligned {name: str}, all_trees [PhyTree])."""
    from .engine.level_driver import progressive_alignment_batched
    from .engine_policy import level_mesh
    from .parallel import distributed

    distributed.maybe_initialize(device)
    if mesh is None:
        mesh = level_mesh(device)

    spec = al.get_alphabet(options)

    seqs2, start_stripped, end_stripped = encode_input(seqs, options, spec)
    any_start_stripped = any(start_stripped.values())
    any_end_stripped = any(end_stripped.values())
    factory = model_factory(options, spec, seqs2)

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

    topo = read_topology(options)
    ckpt = state = None
    if options.checkpoint_dir:
        from .checkpoint import PhaseCheckpoint
        ckpt = PhaseCheckpoint(options, seqs, engine)
        state = ckpt.load()
        ckpt.agree(state)

    if state is not None:
        tree = state["tree"]
        all_trees = state["all_trees"]
        old_aligned = state["old_aligned"]
        start_i = state["i_next"]
    else:
        if options.tree_file:
            with open(options.tree_file) as fh:
                tree = parse_newick(fh.read())
        elif apart is not None and apart.started:
            tree = apart.tree()
        else:
            tree = tree_nj(spec, seqs2, False, factory, options, topo,
                           device, engine, mesh)
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
                csprofile.prime_profiles(leaves, engine, device)
        return progressive_alignment_batched(spec, seqs2, tr, reps,
                                             csprofile, factory, options,
                                             device, engine, mesh)

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
                       options, topo, device, engine, mesh)
        all_trees.append(tree.copy())
        old_aligned = result.aligned_sequences
        if ckpt is not None:
            ckpt.save(i + 1, tree, all_trees, old_aligned)

    if not options.onlytree_flag:
        if options.reroot_flag:
            from .engine.find_root import progressive_alignment_find_root
            result = progressive_alignment_find_root(
                spec, seqs2, tree, reps, csprofile, factory, options, device,
                engine, mesh)
        else:
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
    options = options_from_args(args).replace(engine="native")
    if options.timings_flag:
        timings.enable(True)
    # the input is read once, here; its error is reported after the device's
    try:
        text = read_text(options.sequence_file)
    except FastaError as e:
        text = e
    # the first guide tree is built in a process of its own meanwhile
    with first_tree.Apart(text, options, args.engine) as apart:
        try:
            with timings.phase("card_start"):
                device = engine_device(args.engine, args.device)
        except RuntimeError as e:
            print("error: %s" % e, file=sys.stderr)
            return 2
        return _align_and_write(args, options, device, text, apart)


def _align_and_write(args, options, device, text, apart) -> int:
    try:
        if isinstance(text, FastaError):
            raise text
        seqs, input_order = parse_fasta(text)
        aligned, all_trees = do_align(seqs, options, device, args.engine,
                                      apart=apart)
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
