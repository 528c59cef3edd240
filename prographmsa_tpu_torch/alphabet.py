"""Alphabets and sequence encoding.

Re-derives the behavior of the reference's Alphabet layer
(Alphabet.{h,cpp}) as vectorized numpy table lookups.
Sequences are stored the same way the reference stores them:

* AA / DNA: one int16 per residue holding the *normalized character code*
  ('_', '.', ' ' are canonicalized to '-'); residue values (0..DIM-1 /
  unknown / invalid) are derived via a 256-entry lookup table, exactly like
  ``AA::value()`` (Alphabet.cpp:109-111).
* Codon: one int16 per codon holding the reference's packed codon code
  (0..60 = sense codons in T<C<A<G product order, 61 = unknown 'XXX',
  62 = gap, -1 = invalid), cf. ``Codon::Codon(char,char,char)``
  (Alphabet.cpp:121-156).

All tables are generated from first principles (canonical residue orders and
the standard genetic code) rather than transcribed, and are validated against
the reference binary by the differential test-suite.

DNA note (deliberate divergence): the reference's ``DNA::value()``
(Alphabet.cpp:204-206) indexes the *amino-acid* translation table — an
out-of-bounds bug that makes ``--dna`` segfault the reference binary
(verified: exit 139 on fixtures/dna12.fasta), so no oracle exists for DNA
mode.  The intended table is plainly ``dna_translation_table``
(Alphabet.cpp:22-36, used correctly by the codon packer): T/U->0, C->1,
A->2, G->3, X->4 (unknown), everything else invalid.  ``DNA_VALUE_TABLE``
implements that intent, making ``--dna`` actually work here.
"""

from __future__ import annotations

import numpy as np
from .errors import ParityError

GAP_CHAR = "-"
GAP = -2          # our canonical "gap" value-code (reference: isGap())
INVALID = -1

_AA_ORDER = "ACDEFGHIKLMNPQRSTVWY"   # canonical order (Alphabet.cpp:40-41)
_DNA_ORDER = "TCAG"                  # T<C<A<G (Alphabet.cpp:38, 'X' = 4)


def _make_char_table(mapping: dict, default: int = INVALID) -> np.ndarray:
    t = np.full(256, default, dtype=np.int16)
    for ch, v in mapping.items():
        t[ord(ch)] = v
        t[ord(ch.lower())] = v
    return t


def _aa_char_map() -> dict:
    m = {c: i for i, c in enumerate(_AA_ORDER)}
    for c in "BJOUXZ":               # any other letter -> 20 (unknown)
        m[c] = 20
    return m


# value() tables: char byte -> residue value
AA_VALUE_TABLE = _make_char_table(_aa_char_map())
DNA_CHAR_TABLE = _make_char_table({"T": 0, "U": 0, "C": 1, "A": 2, "G": 3, "X": 4})
# The reference's intended DNA table (see DNA note above); NOT the buggy
# DNA::value() AA-table indexing, which crashes the reference binary.
DNA_VALUE_TABLE = DNA_CHAR_TABLE

# --- codon tables (generated from the standard genetic code) ---
_STOPS = {"TAA", "TAG", "TGA"}
_GENETIC_CODE = {
    # generated below from per-codon translation
}


def _standard_codon_translation(codon: str) -> str:
    """Standard genetic code, codon (DNA, upper) -> one-letter AA."""
    table = {
        "TTT": "F", "TTC": "F", "TTA": "L", "TTG": "L",
        "CTT": "L", "CTC": "L", "CTA": "L", "CTG": "L",
        "ATT": "I", "ATC": "I", "ATA": "I", "ATG": "M",
        "GTT": "V", "GTC": "V", "GTA": "V", "GTG": "V",
        "TCT": "S", "TCC": "S", "TCA": "S", "TCG": "S",
        "CCT": "P", "CCC": "P", "CCA": "P", "CCG": "P",
        "ACT": "T", "ACC": "T", "ACA": "T", "ACG": "T",
        "GCT": "A", "GCC": "A", "GCA": "A", "GCG": "A",
        "TAT": "Y", "TAC": "Y", "CAT": "H", "CAC": "H",
        "CAA": "Q", "CAG": "Q", "AAT": "N", "AAC": "N",
        "AAA": "K", "AAG": "K", "GAT": "D", "GAC": "D",
        "GAA": "E", "GAG": "E", "TGT": "C", "TGC": "C",
        "TGG": "W", "CGT": "R", "CGC": "R", "CGA": "R",
        "CGG": "R", "AGT": "S", "AGC": "S", "AGA": "R",
        "AGG": "R", "GGT": "G", "GGC": "G", "GGA": "G",
        "GGG": "G",
    }
    return table[codon]


def _build_codon_tables():
    """Sense codons indexed in (c1,c2,c3) product order with T<C<A<G."""
    codon_strings = []
    from_product = np.full(64, INVALID, dtype=np.int16)
    for i1, c1 in enumerate(_DNA_ORDER):
        for i2, c2 in enumerate(_DNA_ORDER):
            for i3, c3 in enumerate(_DNA_ORDER):
                cod = c1 + c2 + c3
                if cod in _STOPS:
                    continue
                from_product[16 * i1 + 4 * i2 + i3] = len(codon_strings)
                codon_strings.append(cod)
    assert len(codon_strings) == 61
    codon_aa = "".join(_standard_codon_translation(c) for c in codon_strings) + "X"
    return codon_strings, from_product, codon_aa


CODON_STRINGS, CODON_FROM_PRODUCT, CODON_AA_CHARS = _build_codon_tables()
CODON_X = 61
CODON_GAP = 62


class AlphabetSpec:
    """Static description of one alphabet (AA / DNA / Codon)."""

    def __init__(self, name, dim, value_table, inv_chars, strip_start, strip_end,
                 kmer_k):
        self.name = name
        self.DIM = dim
        self.value_table = value_table      # char/data-code -> residue value
        self.inv_chars = inv_chars          # residue value -> char
        self.strip_start = strip_start      # char stripped at seq start (or None)
        self.strip_end = strip_end
        self.kmer_k = kmer_k                # K for angle distances

    # ------------------------------------------------------------------
    # encoding / decoding
    # ------------------------------------------------------------------
    def encode(self, s: str) -> np.ndarray:
        """string -> sequence codes (raises on gapped input, like
        sequenceFromString, Alphabet.h:122-136)."""
        raise NotImplementedError

    def values(self, seq: np.ndarray) -> np.ndarray:
        """sequence codes -> residue values (reference ``value()``)."""
        raise NotImplementedError

    def is_gap(self, seq: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def is_valid(self, seq: np.ndarray) -> np.ndarray:
        v = self.values(seq)
        return (v >= 0) & (v < self.DIM)


class CharAlphabet(AlphabetSpec):
    """AA and DNA: sequence codes are normalized character bytes."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.gap_code = ord(GAP_CHAR)
        self.x_code = ord("X")

    def encode(self, s: str) -> np.ndarray:
        raw = np.frombuffer(s.encode("latin-1"), dtype=np.uint8).astype(np.int16)
        for c in "_. ":
            raw[raw == ord(c)] = ord(GAP_CHAR)
        if np.any(raw == ord(GAP_CHAR)):
            raise ParityError("No support for gapped sequences (yet)")
        return raw

    def decode(self, seq: np.ndarray) -> str:
        return bytes(np.asarray(seq, dtype=np.int16).astype(np.uint8)).decode("latin-1")

    def from_values(self, values: np.ndarray) -> np.ndarray:
        """residue value -> char code (reference ALPHABET(int) ctor)."""
        out = np.full(len(values), ord("?"), dtype=np.int16)
        for i, ch in enumerate(self.inv_chars):
            out[values == i] = ord(ch)
        return out

    def values(self, seq: np.ndarray) -> np.ndarray:
        return self.value_table[np.asarray(seq, dtype=np.int16)]

    def is_gap(self, seq: np.ndarray) -> np.ndarray:
        return np.asarray(seq) == self.gap_code

    def is_unknown(self, seq: np.ndarray) -> np.ndarray:
        return np.asarray(seq) == self.x_code


class CodonAlphabet(AlphabetSpec):
    """Codon: sequence codes are packed codon codes 0..62 / -1."""

    def __init__(self):
        value_table = np.concatenate(
            [np.arange(61, dtype=np.int16), np.array([61, 62], dtype=np.int16)])
        super().__init__("codon", 61, value_table, CODON_STRINGS,
                         strip_start="ATG", strip_end="XXX", kmer_k=2)
        self.gap_code = CODON_GAP
        self.x_code = CODON_X

    def encode(self, s: str) -> np.ndarray:
        codes = []
        n = len(s)
        for i in range(0, n - 2, 3):
            c = self._pack(s[i], s[i + 1], s[i + 2])
            if c == CODON_GAP:
                raise ParityError("No support for gapped sequences (yet)")
            codes.append(c)
        if n % 3 != 0:
            codes.append(INVALID)
        return np.array(codes, dtype=np.int16)

    @staticmethod
    def _pack(c1: str, c2: str, c3: str) -> int:
        # Codon::Codon(char,char,char), Alphabet.cpp:121-156
        if any(c in "_-. " for c in (c1, c2, c3)):
            return CODON_GAP
        t = DNA_CHAR_TABLE
        v3, v2, v1 = t[ord(c3)], t[ord(c2)], t[ord(c1)]
        c = int(v3)
        if c < 0:
            return INVALID
        if c >= 4:
            return CODON_X
        c += 4 * int(v2)
        if v2 < 0:
            return INVALID
        if c >= 16:
            return CODON_X
        c += 16 * int(v1)
        if v1 < 0:
            return INVALID
        if c >= 64:
            return CODON_X
        return int(CODON_FROM_PRODUCT[c])

    def decode(self, seq: np.ndarray) -> str:
        out = []
        for c in np.asarray(seq, dtype=np.int16):
            if c == CODON_GAP:
                out.append(GAP_CHAR * 3)
            elif 0 <= c < 61:
                out.append(CODON_STRINGS[c])
            else:
                out.append("XXX")
        return "".join(out)

    def as_aa_chars(self, seq: np.ndarray) -> str:
        """Codon::asChar() per element (Alphabet.cpp:181-188)."""
        out = []
        for c in np.asarray(seq, dtype=np.int16):
            if c == CODON_GAP:
                out.append(GAP_CHAR)
            elif 0 <= c <= 61:
                out.append(CODON_AA_CHARS[c])
            else:
                out.append("X")
        return "".join(out)

    def values(self, seq: np.ndarray) -> np.ndarray:
        # Codon::value(): gap -> -1, else data (Alphabet.cpp:166-169)
        seq = np.asarray(seq, dtype=np.int16)
        v = seq.copy()
        v[seq == CODON_GAP] = INVALID
        return v

    def is_gap(self, seq: np.ndarray) -> np.ndarray:
        return np.asarray(seq) == CODON_GAP

    def is_unknown(self, seq: np.ndarray) -> np.ndarray:
        return np.asarray(seq) == CODON_X

    def from_values(self, values: np.ndarray) -> np.ndarray:
        out = np.asarray(values, dtype=np.int16).copy()
        out[(out < 0) | (out > 61)] = INVALID
        return out


AA_SPEC = CharAlphabet("aa", 20, AA_VALUE_TABLE, _AA_ORDER + "X",
                       strip_start="M", strip_end=None, kmer_k=2)
DNA_SPEC = CharAlphabet("dna", 4, DNA_VALUE_TABLE, "TCAGX",
                        strip_start=None, strip_end=None, kmer_k=6)
CODON_SPEC = CodonAlphabet()


def get_alphabet(options) -> AlphabetSpec:
    if options.codon_flag:
        return CODON_SPEC
    if options.dna_flag:
        return DNA_SPEC
    return AA_SPEC


def translate_codons(seq: np.ndarray) -> np.ndarray:
    """sequence_t<Codon> -> sequence_t<AA> (Alphabet.cpp:216-225)."""
    chars = CODON_SPEC.as_aa_chars(seq)
    return AA_SPEC.encode(chars) if GAP_CHAR not in chars else np.array(
        [ord(c) for c in chars], dtype=np.int16)


def string_from_sequence(spec: AlphabetSpec, seq: np.ndarray, orig: str = None) -> str:
    """stringFromSequence (Alphabet.h:140-169, Alphabet.cpp:227-257):
    restore original characters through gaps."""
    seq = np.asarray(seq, dtype=np.int16)
    if isinstance(spec, CodonAlphabet):
        if orig is None:
            return spec.decode(seq)
        res = np.full((len(seq), 3), ord(GAP_CHAR), dtype=np.uint8)
        keep = seq != CODON_GAP
        ob = np.frombuffer(orig.encode("latin-1"), dtype=np.uint8)
        assert int(keep.sum()) * 3 == len(orig)
        res[keep] = ob.reshape(-1, 3)
        return res.tobytes().decode("latin-1")
    if orig is None:
        return spec.decode(seq)
    keep = seq != spec.gap_code
    ob = np.frombuffer(orig.encode("latin-1"), dtype=np.uint8)
    assert int(keep.sum()) == len(orig)
    res = np.full(len(seq), ord(GAP_CHAR), dtype=np.uint8)
    res[keep] = ob
    return res.tobytes().decode("latin-1")
