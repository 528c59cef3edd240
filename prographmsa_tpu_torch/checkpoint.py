"""Phase checkpoint / resume (``--checkpoint_dir``, extension flag).

The reference's only resume mechanisms are --trd_output/--read_repeats and
manual tree re-injection via -t (SURVEY §5 "Checkpoint/resume").  This module
serializes the guide-tree iteration state — the current tree, the tree
history, and the previous iteration's induced alignment — after every
distance+NJ phase, so an interrupted run restarts at the last completed
iteration instead of from scratch.

State is keyed by a fingerprint of the input sequences and every
alignment-relevant option; a stale or mismatched checkpoint is ignored (never
trusted), so resuming can only skip work, not change results
(tests/test_checkpoint.py asserts byte-identical output with and without
resume).
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import pickle
from typing import Dict, Optional

STATE_FILE = "phase_state.pkl"
FORMAT = 1


def _fingerprint(options, seqs: Dict[str, str]) -> str:
    h = hashlib.sha1()
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


class PhaseCheckpoint:
    def __init__(self, options, seqs: Dict[str, str]):
        self.dir = options.checkpoint_dir
        os.makedirs(self.dir, exist_ok=True)
        self.key = _fingerprint(options, seqs)
        self.path = os.path.join(self.dir, STATE_FILE)

    def load(self) -> Optional[dict]:
        """The saved state, or None when absent/stale/incompatible."""
        try:
            with open(self.path, "rb") as f:
                state = pickle.load(f)
        except (OSError, pickle.UnpicklingError, EOFError, AttributeError):
            return None
        if (not isinstance(state, dict) or state.get("format") != FORMAT
                or state.get("key") != self.key):
            return None
        return state

    def save(self, i_next: int, tree, all_trees, old_aligned) -> None:
        state = {
            "format": FORMAT,
            "key": self.key,
            "i_next": i_next,
            "tree": tree,
            "all_trees": all_trees,
            "old_aligned": old_aligned,
        }
        tmp = self.path + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(state, f, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, self.path)
