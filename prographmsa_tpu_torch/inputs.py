"""The input as the run's stages take it: sequences encoded and stripped,
the model factory, the ``--topology`` tree.  cli.do_align and the first
guide tree's own process (first_tree.py) both start from these."""

from __future__ import annotations

from typing import Dict

import numpy as np

from . import alphabet as al
from .io.newick import parse_newick
from .models.factory import get_default_model_factory


def encode_input(seqs: Dict[str, str], options, spec):
    """(encoded {name: array}, start_stripped, end_stripped): each sequence
    encoded, its start and stop codons stripped (main.cpp:326-353)."""
    start_stripped, end_stripped = {}, {}
    seqs2: Dict[str, np.ndarray] = {}
    for name in seqs:
        enc = spec.encode(seqs[name])
        start_stripped[name] = end_stripped[name] = False
        if not options.noforcealign_flag:
            if spec.strip_start is not None and len(enc):
                if enc[0] == spec.encode(spec.strip_start)[0]:
                    enc = enc[1:]
                    start_stripped[name] = True
            if spec.strip_end is not None and len(enc):
                if spec.name == "codon" and enc[-1] == al.CODON_X:
                    enc = enc[:-1]
                    end_stripped[name] = True
        seqs2[name] = enc
    return seqs2, start_stripped, end_stripped


def model_factory(options, spec, seqs2):
    return get_default_model_factory(
        options, spec, {n: spec.values(s) for n, s in seqs2.items()})


def read_topology(options):
    """The ``--topology`` tree, or None."""
    if not options.topo_file:
        return None
    with open(options.topo_file) as fh:
        return parse_newick(fh.read())
