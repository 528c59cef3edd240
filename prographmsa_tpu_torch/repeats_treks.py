"""Tandem-repeat detection and repeat-unit re-alignment.

Re-derivation of RepeatDetectionTReks.{h,cpp}:

* ``parse_treks_output``: parse T-Reks format (per-sequence blocks
  ``Length: .. from S to E``, one aligned unit per line) into per-residue
  unit-column tracks, cross-checking every character against the original
  sequence (RepeatDetectionTReks.cpp:61-151).
* ``detect_repeats``: run ``java -jar T-Reks.jar`` (or --custom_tr_cmd) via
  a subprocess, tee to --trd_output (RepeatDetectionTReks.cpp:159-197).
* ``align_repeats``: re-align each repeat's units with the *full MSA
  pipeline* recursively and rewrite the homology track from the unit MSA
  (RepeatDetectionTReks.h:94-152).
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np

from .alphabet import string_from_sequence, AA_SPEC, translate_codons


class TreksError(Exception):
    pass


@dataclass
class Repeat:
    len: int = 0
    start: int = 0
    tr_hom: List[int] = field(default_factory=list)


def parse_treks_output(text: str, seqs: Dict[str, str]):
    """T-Reks format -> {name: [Repeat]} (RepeatDetectionTReks.cpp:61-151)."""
    out: Dict[str, List[Repeat]] = {}
    n_sequences = 0
    n_repeats = 0
    name = ""
    lines = text.split("\n")
    i = 0
    while i < len(lines):
        line = lines[i]
        i += 1
        if line.startswith(">"):
            name = line[1:].strip(" \t\f\v\n\r")
            n_sequences += 1
        elif line.startswith("Length:"):
            ifrom = line.find("from")
            if ifrom < 0:
                raise TreksError("format error (from)")
            ito = line.find("to", ifrom)
            if ito < 0:
                raise TreksError("format error (to)")
            rep = Repeat()
            n_repeats += 1
            try:
                start = int(line[ifrom + 4:ito].split()[0])
            except (ValueError, IndexError):
                raise TreksError("format error (number)")
            if start <= 0:
                raise TreksError("format error (number)")
            rep.start = start - 1
            if name not in seqs:
                raise TreksError("unknown sequence name: " + name)
            orig = seqs[name]
            pos = rep.start
            rep.len = -1
            line_no = 0
            while i < len(lines):
                unit = lines[i].strip(" \t\f\v\n\r")
                i += 1
                line_no += 1
                if unit.startswith("**********************"):
                    break
                unit = "".join("_" if c in "- \n\t\r" else c for c in unit)
                if rep.len != -1 and len(unit) != rep.len:
                    raise TreksError("repeat unit lengths differ")
                rep.len = len(unit)
                for col, c in enumerate(unit):
                    if c != "_":
                        rep.tr_hom.append(col)
                        if pos >= len(orig) or orig[pos] != c:
                            raise TreksError(
                                'character mismatch (repeat %d, seq "%s", '
                                "orig pos %d char '%s', trmsa line %d pos %d)"
                                % (n_repeats, name, pos + 1, c, line_no,
                                   col + 1))
                        pos += 1
            out.setdefault(name, []).append(rep)
    print("found %d repeats in %d sequences" % (n_repeats, n_sequences),
          file=sys.stderr)
    return out


def _seq_strings(seqs2: Dict[str, np.ndarray], spec) -> Dict[str, str]:
    if spec.name == "codon":
        return {n: string_from_sequence(AA_SPEC, translate_codons(s))
                for n, s in seqs2.items()}
    return {n: string_from_sequence(spec, s) for n, s in seqs2.items()}


def read_repeats(filename: str, seqs2: Dict[str, np.ndarray], spec):
    with open(filename) as f:
        text = f.read()
    return parse_treks_output(text, _seq_strings(seqs2, spec))


def detect_repeats(seqs2: Dict[str, np.ndarray], spec, options):
    """Run the external detector (RepeatDetectionTReks.cpp:159-197).
    Codon sequences are detected on their AA translation
    (RepeatDetectionTReks.cpp:6-33)."""
    strs = _seq_strings(seqs2, spec)
    with tempfile.NamedTemporaryFile("w", prefix="tmpseqrep-",
                                     suffix=".fasta", delete=False) as tmp:
        for n in sorted(strs):
            tmp.write(">%s\n%s\n" % (n, strs[n]))
        fname = tmp.name
    if options.customtr_cmd:
        cmd = '%s "%s"' % (options.customtr_cmd, fname)
    else:
        # the reference compiles the jar path in via CMake
        # (external_programs.cpp.in:1-2); here it is env-configurable
        jar = os.environ.get("PROGRAPHMSA_TREKS_JAR", "T-Reks.jar")
        cmd = 'java -jar %s -infile="%s"' % (jar, fname)
    proc = subprocess.run(cmd, shell=True, capture_output=True, text=True)
    text = proc.stdout
    if options.trdout_file:
        with open(options.trdout_file, "w") as f:
            f.write(text)
    return parse_treks_output(text, strs)


def align_repeats(seqs2, reps, csprofile, factory, options, spec):
    """Re-align repeat units with the full pipeline
    (RepeatDetectionTReks.h:94-152)."""
    from .tree.treenj import tree_nj
    from .engine.progressive import progressive_alignment

    new_reps: Dict[str, List[Repeat]] = {}
    for seq_name in reps:
        seq = seqs2[seq_name]
        new_list = []
        for cur in reps[seq_name]:
            units: Dict[str, np.ndarray] = {}
            unit_names = []
            start = 0
            unit = 0
            while start < len(cur.tr_hom):
                end = start + 1
                while (end < len(cur.tr_hom)
                       and cur.tr_hom[end] > cur.tr_hom[end - 1]):
                    end += 1
                sunit = str(unit)
                unit_names.append(sunit)
                units[sunit] = seq[cur.start + start:cur.start + end]
                unit += 1
                start = end

            tree = tree_nj(spec, units, False, factory, options)
            result = progressive_alignment(spec, units, tree, {}, csprofile,
                                           factory, options, {})

            new = Repeat()
            new.start = cur.start
            new.len = len(result.aligned_sequences[unit_names[0]])
            gap = spec.gap_code
            for sunit in unit_names:
                s = result.aligned_sequences[sunit]
                for i in range(new.len):
                    if s[i] != gap:
                        new.tr_hom.append(i)
            assert len(cur.tr_hom) == len(new.tr_hom)
            new_list.append(new)
        new_reps[seq_name] = new_list
    return new_reps
