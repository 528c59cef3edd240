"""Phase checkpoint / resume (``--checkpoint_dir``, extension flag).

The reference's only resume mechanisms are --trd_output/--read_repeats and
manual tree re-injection via -t (SURVEY §5 "Checkpoint/resume").  This module
serializes the guide-tree iteration state — the current tree, the tree
history, and the previous iteration's induced alignment — after every
distance+NJ phase, so an interrupted run restarts at the last completed
iteration instead of from scratch.

The state is the port's own: it lives in STATE_FILE, a name the JAX
package never reads, and is keyed by a fingerprint of a package tag, the
port's ``--engine`` (under ``device`` the float32 angle Gram may give
another guide tree), every alignment-relevant option and the input
sequences.  ``--device`` and the mesh stay out of the key: their results
are identical by design.  The file is read by an unpickler that admits
only the classes defined in the port's own modules, numpy's array, scalar
and dtype reconstructors and plain builtin containers; anything else, a
missing module, a key or format that differs, or a state whose trees are
not the port's PhyTree, makes the state stale.  A stale state is
recomputed, never trusted and never fatal, so resuming can only skip
work, not change results (tests/test_torch_checkpoint.py: byte-identical
output with and without resume, under each engine, beside a state of the
JAX package and a forged one).

In a process group every process loads, then all of them gather what they
found (``agree``): the gather is the barrier before the first save, and
processes that found different states raise.  Only process 0 saves.
"""

from __future__ import annotations

import dataclasses
import hashlib
import io
import os
import pickle
import tempfile
from typing import Dict, Optional

import numpy as np

from .parallel import distributed
from .tree.phytree import PhyTree

STATE_FILE = "phase_state_torch.pkl"
FORMAT = 2
TAG = b"prographmsa_tpu_torch\0"

# What a state may name besides the port's own classes: numpy's array,
# scalar and dtype reconstructors (numpy 1 and 2 module names) and the
# builtin containers.
_ADMITTED = {
    "numpy": {"dtype", "ndarray"},
    "numpy.core.multiarray": {"_reconstruct", "scalar"},
    "numpy._core.multiarray": {"_reconstruct", "scalar"},
    "numpy.core.numeric": {"_frombuffer"},
    "numpy._core.numeric": {"_frombuffer"},
    "builtins": {"dict", "list", "tuple", "set", "frozenset"},
}


class _PortUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module in _ADMITTED and name in _ADMITTED[module]:
            return super().find_class(module, name)
        if (module.split(".")[0] == "prographmsa_tpu_torch"
                and name.isidentifier()):
            obj = super().find_class(module, name)
            if isinstance(obj, type) and obj.__module__ == module:
                return obj
        raise pickle.UnpicklingError("not a state of the port: %s.%s"
                                     % (module, name))


def _fingerprint(options, seqs: Dict[str, str], engine: str) -> str:
    h = hashlib.sha1(TAG)
    h.update(engine.encode() + b"\0")
    # every option except output/observability knobs affects the result
    neutral = dataclasses.replace(options, checkpoint_dir="", output_file="",
                                  timings_flag=False)
    h.update(repr(neutral).encode())
    for name in sorted(seqs):
        h.update(name.encode())
        h.update(b"\0")
        h.update(seqs[name].encode())
        h.update(b"\1")
    return h.hexdigest()


def _is_state(state, key: str) -> bool:
    return (isinstance(state, dict) and state.get("format") == FORMAT
            and state.get("key") == key
            and type(state.get("i_next")) is int
            and isinstance(state.get("tree"), PhyTree)
            and isinstance(state.get("all_trees"), list)
            and all(isinstance(t, PhyTree) for t in state["all_trees"])
            and (state.get("old_aligned") is None
                 or isinstance(state["old_aligned"], dict)))


class PhaseCheckpoint:
    def __init__(self, options, seqs: Dict[str, str], engine: str):
        self.dir = options.checkpoint_dir
        os.makedirs(self.dir, exist_ok=True)
        self.key = _fingerprint(options, seqs, engine)
        self.path = os.path.join(self.dir, STATE_FILE)
        self.digest = 0           # of the bytes load() last accepted

    def load(self) -> Optional[dict]:
        """The saved state, or None when absent, stale, foreign or
        unreadable."""
        try:
            with open(self.path, "rb") as f:
                raw = f.read()
            state = _PortUnpickler(io.BytesIO(raw)).load()
        except Exception:  # noqa: BLE001 — an unreadable state is stale
            return None
        if not _is_state(state, self.key):
            return None
        self.digest = int.from_bytes(hashlib.sha1(raw).digest()[:8],
                                     "little") >> 1
        return state

    def agree(self, state: Optional[dict]) -> None:
        """Across a process group: every process's ``i_next`` (-1 for no
        state) and the digest of what it loaded, gathered; raises
        RuntimeError where they differ.  A collective, so no process
        saves before every process has loaded.  Alone, nothing."""
        if distributed.world() == 1:
            return
        mine = (np.array([state["i_next"], self.digest], np.int64)
                if state is not None else np.array([-1, 0], np.int64))
        found = [tuple(int(v) for v in a)
                 for a in distributed.all_gather(mine)]
        if len(set(found)) > 1:
            raise RuntimeError(
                "--checkpoint_dir: the processes found different states "
                "(i_next by rank, -1 for none: %s); give them one directory "
                "or empty ones" % [i for i, _ in found])

    def save(self, i_next: int, tree, all_trees, old_aligned) -> None:
        """Write the state (atomically, through a temporary file of this
        process's own); in a process group only process 0 writes."""
        if distributed.rank() != 0:
            return
        state = {
            "format": FORMAT,
            "key": self.key,
            "i_next": i_next,
            "tree": tree,
            "all_trees": all_trees,
            "old_aligned": old_aligned,
        }
        fd, tmp = tempfile.mkstemp(prefix=STATE_FILE + ".", suffix=".tmp",
                                   dir=self.dir)
        try:
            with os.fdopen(fd, "wb") as f:
                pickle.dump(state, f, protocol=pickle.HIGHEST_PROTOCOL)
            os.replace(tmp, self.path)
        except BaseException:
            os.unlink(tmp)
            raise
