"""Command line of the PyTorch/CUDA port: the reference CLI
(prographmsa_tpu/cli.py) with the graph-pair DP of every progressive pass
on the port's device batch.

  python -m prographmsa_tpu_torch.cli [reference flags] \\
      [--engine torch|native] [--device cuda|cpu] sequences.fasta

``--engine torch`` (default) runs each guide-tree level's DP batch on
``--device`` (default ``cuda``, which must exist: there is no silent CPU
run; ``cpu`` runs the kernels' plain PyTorch versions).  ``--engine native``
keeps the DP on the reference's C++ host tier.  The guide-tree distances
run on the host in both.  ``-r`` and ``--early_refinement`` are not ported
yet and exit with an error.
"""

from __future__ import annotations

import sys
from typing import Dict

import numpy as np

from prographmsa_tpu import alphabet as al
from prographmsa_tpu import cli as ref_cli
from prographmsa_tpu import timings
from prographmsa_tpu.errors import ParityError
from prographmsa_tpu.io.fasta import FastaError, read_fasta, write_fasta
from prographmsa_tpu.io.newick import parse_newick
from prographmsa_tpu.io.stockholm import write_stockholm
from prographmsa_tpu.models.factory import get_default_model_factory
from prographmsa_tpu.tree.phytree import get_tree_order
from prographmsa_tpu.tree.treenj import tree_nj

from .engine_policy import ENGINES, use_torch_dp

NOT_PORTED = {
    "reroot": "-r/--reroot",
    "early_refinement": "--early_refinement",
}


def build_parser():
    p = ref_cli.build_parser()
    p.prog = "ProGraphMSA-Torch"
    for act in p._actions:
        if "--engine" in act.option_strings:
            act.choices = ENGINES
            act.default = "torch"
            act.help = ("DP engine: torch = the port's device batch on "
                        "--device; native = the C++ host tier")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="torch device of the DP batch (cuda must exist)")
    return p


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
        from prographmsa_tpu.cs_profile import CSProfileLibrary
        csprofile = CSProfileLibrary(options.cs_file)

    reps: Dict[str, list] = {}
    if options.readreps_file:
        from prographmsa_tpu.repeats_treks import read_repeats
        reps = read_repeats(options.readreps_file, seqs2, spec)
    elif options.repeats_flag:
        from prographmsa_tpu.repeats_treks import align_repeats, detect_repeats
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
        from prographmsa_tpu.checkpoint import PhaseCheckpoint
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
                csprofile.prime_profiles(leaves, engine=options.engine)
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
        if i > 0 and ref_cli._aligned_equal(result.aligned_sequences,
                                            old_aligned):
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
        from prographmsa_tpu.io.profile_out import write_profile
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


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    for dest, flag in NOT_PORTED.items():
        if getattr(args, dest):
            print("error: %s is not ported to the torch package yet "
                  "(ROADMAP.md, modules still to port: -r find-root and "
                  "--early_refinement on the device DP)" % flag,
                  file=sys.stderr)
            return 2
    port_options = ref_cli.options_from_args(args)
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
