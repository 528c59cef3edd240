"""FASTA reading/writing (behavioral parity with Fasta.cpp).

Reader: streaming, order-preserving, rejects duplicate names, strips
whitespace from name and sequence lines (Fasta.cpp:49-80).
Writers: one header line + one sequence line per record (Fasta.cpp:116-126).
"""

from __future__ import annotations

from typing import Dict, List, Tuple


class FastaError(Exception):
    """Mirrors fasta_exception (Fasta.cpp:41,45): uncaught in the reference
    main, so it terminates the process via std::terminate (exit 134)."""


class FastaAbort(Exception):
    """Mirrors the error() path (Fasta.cpp:88,102 -> debug.cpp:44-52):
    prints "error: msg" to stderr and aborts (exit 134)."""


def read_fasta(path: str) -> Tuple[Dict[str, str], List[str]]:
    """Returns ({name: seq}, input_order). Mirrors FastaLib::readAll."""
    try:
        with open(path, "r") as f:
            text = f.read()
    except OSError:
        raise FastaError("error opening file")
    if not text.startswith(">"):
        raise FastaError("format error")
    seqs: Dict[str, str] = {}
    order: List[str] = []
    name = None
    chunks: List[str] = []
    for line in text.split("\n"):
        if line.startswith(">"):
            if name is not None:
                seqs[name] = "".join(chunks)
            name = line[1:].strip(" \t\f\v\n\r")
            if name in seqs:
                raise FastaError('duplicate sequence name "%s"' % name)
            order.append(name)
            chunks = []
        else:
            chunks.append(line.strip(" \t\f\v\n\r"))
    if name is not None:
        seqs[name] = "".join(chunks)
    return seqs, order


def write_fasta(alignment: Dict[str, str], order: List[str], out) -> None:
    for name in order:
        out.write(">%s\n%s\n" % (name, alignment[name]))
