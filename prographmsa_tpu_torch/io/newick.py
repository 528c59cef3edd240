"""Newick parser (behavioral parity with newick.cpp).

Tokenizer splits on ``, : ( ) ;`` and whitespace; branch supports before ':'
are parsed and ignored (newick.cpp:96-103); a trailing root branch length is
consumed (newick.cpp:128-139).
"""

from __future__ import annotations

from ..tree.phytree import PhyTree

_SEPS = set(",:();")


class NewickError(Exception):
    pass


class _Tokens:
    def __init__(self, text: str):
        self.toks = self._tokenize(text)
        self.i = 0

    @staticmethod
    def _tokenize(text: str):
        toks = []
        cur = ""
        for ch in text:
            if ch.isspace():
                if cur:
                    toks.append(cur)
                    cur = ""
                continue
            if ch in _SEPS:
                if cur:
                    toks.append(cur)
                    cur = ""
                toks.append(ch)
            else:
                cur += ch
        if cur:
            toks.append(cur)
        return toks

    def peek(self) -> str:
        if self.i >= len(self.toks):
            raise NewickError("Unexpected EOF")
        return self.toks[self.i]

    def next(self) -> str:
        t = self.peek()
        self.i += 1
        return t


def _parse_double(s: str) -> float:
    # istringstream >> double: parse the leading numeric prefix, 0 on failure
    import re
    m = re.match(r"[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?", s)
    return float(m.group(0)) if m else 0.0


def _parse_tree(buf: _Tokens) -> PhyTree:
    t = PhyTree()
    tok = buf.next()
    if tok != "(":
        raise NewickError("Unexpected token: '%s', expected: '('" % tok)
    while True:
        tok = buf.peek()
        if tok == "(":
            child = _parse_tree(buf)
        else:
            child = PhyTree(buf.next())
        tok = buf.next()
        if tok != ":":
            # ignored branch support
            tok = buf.next()
            if tok != ":":
                raise NewickError("Unexpected token: '%s', expected: ':'" % tok)
        tok = buf.next()
        dist = _parse_double(tok)
        t.add_child(child, dist)
        tok = buf.peek()
        if tok == ")":
            buf.next()
            break
        tok = buf.next()
        if tok != ",":
            raise NewickError("Unexpected token: '%s', expected: ','" % tok)
    return t


def parse_newick(text: str) -> PhyTree:
    buf = _Tokens(text)
    t = _parse_tree(buf)
    tok = buf.next()
    if tok != ";":
        if tok != ":":
            _parse_double(tok)
            tok = buf.next()
        if tok != ":":
            raise NewickError("Unexpected token: %s" % tok)
        tok = buf.next()
        _parse_double(tok)
        tok = buf.next()
    if tok != ";":
        raise NewickError("Unexpected token: %s" % tok)
    return t
