"""Stockholm 1.0 writer (parity with Stockholm.cpp).

The reference embeds a build-date string in the header comment
(``LogoDate``); we print our own version tag there — differential tests
compare all lines except this header comment.
"""

from __future__ import annotations

from typing import Dict, List

VERSION_TAG = "ProGraphMSA-TPU"


def write_stockholm(alignment: Dict[str, str], order: List[str], tree,
                    out, all_trees=None) -> None:
    out.write("# STOCKHOLM 1.0\n")
    out.write("# created by ProGraphMSA %s\n" % VERSION_TAG)
    for name in order:
        out.write("%s\t%s\n" % (name, alignment[name]))
    if all_trees is not None:
        for i, t in enumerate(all_trees):
            out.write("#=GF TN guide_tree_iteration_%d\n" % i)
            out.write("#=GF NH\t%s\n" % t.format_newick())
    out.write("#=GF TN guide_tree\n")
    out.write("#=GF NH\t%s\n" % tree.format_newick())
    out.write("//\n")
