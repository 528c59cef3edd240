"""The first guide tree in a process of its own while the CLI imports torch.

A run on the card first imports torch: seconds of Python (PERF.md §5).
The first guide tree (angle distances and NJ) needs no card, so the CLI
builds it beside that import, in a process forked before the import from
the input's text the CLI has read.  On a thread of the CLI's own process
the two shared the GIL and the walls rose (PERF.md §6).  ``Apart`` forks
that process; ``tree`` waits for it (``--timings`` phase ``tree_wait``)
and takes back the tree, what it wrote to ``sys.stderr`` and the phases it
recorded, each under its name with ``_apart`` added (``distances_apart``,
``nj_apart``: off this process's wall), or raises its error again here.
"""

from __future__ import annotations

import io
import multiprocessing
import sys

from . import alphabet as al
from . import timings
from .engine_policy import needs_card, use_device_angle
from .inputs import encode_input, model_factory, read_topology
from .io.fasta import parse_fasta
from .tree.phytree import PhyTree
from .tree.treenj import tree_nj


def first_tree(text: str, options, engine: str):
    """The first guide tree of the FASTA ``text`` on the host, as
    cli.do_align builds it when no stage of it is on the card."""
    spec = al.get_alphabet(options)
    seqs2 = encode_input(parse_fasta(text)[0], options, spec)[0]
    return tree_nj(spec, seqs2, False, model_factory(options, spec, seqs2),
                   options, read_topology(options), None, engine, None)


def pays(options, engine: str) -> bool:
    """Whether the first tree is built apart: the run imports torch (its
    engine needs the card and this process has not imported it, so the
    fork copies none of torch's threads), and the tree is to be built, on
    the host (no ``-t``, no ``--nwdist``, not the card's Gram, no
    ``--checkpoint_dir`` whose state may hold it)."""
    return (needs_card(engine) and "torch" not in sys.modules
            and not (options.tree_file or options.nwdist_flag
                     or options.checkpoint_dir)
            and not use_device_angle(engine))


class Apart:
    """``first_tree(text, options, engine)`` in a forked process, started
    here when the input was read (``text`` a str) and it ``pays``; else
    ``started`` is False.  On leaving its ``with`` block the process is
    stopped if its tree was not taken."""

    def __init__(self, text, options, engine: str):
        self.proc = None
        if not (isinstance(text, str) and pays(options, engine)):
            return
        ctx = multiprocessing.get_context("fork")
        self._conn, child = ctx.Pipe(duplex=False)
        self.proc = ctx.Process(target=_build, daemon=True,
                                args=(child, text, options, engine,
                                      timings.enabled()))
        self.proc.start()
        child.close()
        self._taken = False

    @property
    def started(self) -> bool:
        return self.proc is not None

    def tree(self):
        """The process's tree; raises its error, or RuntimeError where it
        gave no reply."""
        self._taken = True
        with timings.phase("tree_wait"):
            try:
                ok, value, err, recorded = self._conn.recv()
            except EOFError:
                self.proc.join()
                raise RuntimeError("the first guide tree's process exited "
                                   "%d" % self.proc.exitcode) from None
            self.proc.join()
        sys.stderr.write(err)
        timings.merge(recorded, suffix="_apart")
        if not ok:
            raise value
        return unflatten(value)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if self.proc is not None and not self._taken:
            self.proc.kill()
            self.proc.join()


def _build(conn, text, options, engine, timed) -> None:
    """The forked process of ``Apart``: one tree, one reply; what it
    writes to ``sys.stderr`` goes back in the reply, to be written where
    the tree is taken."""
    sys.stderr = err = io.StringIO()
    timings.enable(timed)
    try:
        reply = (True, flatten(first_tree(text, options, engine)))
    except Exception as e:  # noqa: BLE001 — raised again by Apart.tree
        reply = (False, e)
    conn.send(reply + (err.getvalue(), timings.recorded()))
    conn.close()


def flatten(tree: PhyTree) -> list:
    """The tree as rows (name, parent's row, branch length, branch
    support) in preorder, root first: pickled whatever its depth (a
    pickled PhyTree nests a few frames per level)."""
    rows, stack = [], [(tree, -1)]
    while stack:
        node, up = stack.pop()
        rows.append((node.name, up, node.branch_length,
                     node.branch_support))
        stack.extend((c, len(rows) - 1) for c in reversed(node.children))
    return rows


def unflatten(rows: list) -> PhyTree:
    """The PhyTree of ``flatten``'s rows, children in their order."""
    nodes = []
    for name, up, length, support in rows:
        node = PhyTree(name)
        if up >= 0:
            nodes[up].add_child(node, length, support)
        node.branch_length, node.branch_support = length, support
        nodes.append(node)
    return nodes[0]
