"""Host time of the root search's gap-parsimony scoring.

The port's CLI runs once in this process under ``-r`` (its root search
aligns every edge of the tree graph); then every edge's root alignment is
scored by this tree's ``score_alignments`` (one call for all edges) and,
with --parent DIR, by DIR's ``score_alignment`` edge by edge, as DIR's
``find_root.py`` called it.  DIR is the root of another checkout of this
repository (e.g. a ``git archive`` of the parent commit unpacked into the
gitignored ``_parent/``); only its ``engine/gap_parsimony.py`` is loaded.
The two lists of scores must be equal.

    python3 root_score_time.py [--parent DIR] [--repeat N] CLI_ARGS...

CLI_ARGS are the port CLI's own (they must hold ``-r``), e.g.
``--fasta -r -i 0 --engine native --device cpu fixtures/fam500.fasta``.
Prints one JSON line: the edges, their alignments' widths, the wall of the
CLI run, each timing of the two scorers in seconds (N each, in turns) and
whether the scores are equal; exits 1 if they are not.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import io
import json
import os
import sys
import tempfile
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent")
    ap.add_argument("--repeat", type=int, default=2)
    args, cli_args = ap.parse_known_args()
    if "-r" not in cli_args:
        raise SystemExit("root_score_time: the CLI arguments need -r")

    from prographmsa_tpu_torch import cli
    from prographmsa_tpu_torch.engine import find_root
    from prographmsa_tpu_torch.engine.gap_parsimony import score_alignments

    graphs = []
    tree_graph = find_root.tree_graph

    def recording(spec, *a, **kw):
        out = tree_graph(spec, *a, **kw)
        graphs.append((spec, out[1]))
        return out

    find_root.tree_graph = recording
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(io.StringIO()):
            rc = cli.main(cli_args + ["-o", os.path.join(tmp, "out")])
        cli_s = time.perf_counter() - t0
    find_root.tree_graph = tree_graph
    if rc != 0 or not graphs:
        raise SystemExit("root_score_time: the CLI run failed (rc %s)" % rc)
    spec, edges = graphs[-1]
    gap = spec.gap_code

    parent = None
    if args.parent:
        path = os.path.join(args.parent, "prographmsa_tpu_torch", "engine",
                            "gap_parsimony.py")
        mod_spec = importlib.util.spec_from_file_location(
            "parent_gap_parsimony", path)
        parent = importlib.util.module_from_spec(mod_spec)
        mod_spec.loader.exec_module(parent)

    def timed(fn):
        t = time.perf_counter()
        out = fn()
        return time.perf_counter() - t, out

    new_s, old_s, equal = [], [], True
    for _ in range(args.repeat):
        s, scores = timed(lambda: score_alignments(edges, gap))
        new_s.append(s)
        if parent is not None:
            s, old = timed(lambda: [parent.score_alignment(e.alignment, e,
                                                           gap)
                                    for e in edges])
            old_s.append(s)
            equal = equal and old == scores
    widths = [len(next(iter(e.alignment.aligned_sequences.values())))
              for e in edges]
    print(json.dumps({"edges": len(edges), "width_min": min(widths),
                      "width_max": max(widths), "cli_s": cli_s,
                      "score_s": new_s, "parent_score_s": old_s,
                      "best_score": min(scores), "equal": equal}))
    sys.exit(0 if equal else 1)


if __name__ == "__main__":
    main()
