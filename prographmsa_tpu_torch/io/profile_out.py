"""Ancestral profile writer (--profile_out), parity with
profile.h:12-30.

Profiles iterate in sorted-name order (std::map); values print with C++
default ostream precision (6 significant digits).  Our profiles are stored
[L, DIM] (row per column); the reference's are DIM x L — we emit rows per
residue like the reference.
"""

from __future__ import annotations

from ..tree.phytree import _fmt


def write_profile(profiles, out, spec=None):
    for name in sorted(profiles):
        profile = profiles[name]          # [L, DIM]
        out.write(">%s\n" % name)
        dim = profile.shape[1] if profile.size else (
            spec.DIM if spec is not None else 20)
        for j in range(dim):
            if spec is not None:
                row_label = spec.inv_chars[j] if j < len(spec.inv_chars) else "?"
            else:
                row_label = "ACDEFGHIKLMNPQRSTVWYX"[j]
            out.write(row_label)
            for k in range(profile.shape[0]):
                out.write("\t" + _fmt(profile[k, j]))
            out.write("\n")
