"""Times the NW kernel D2 (csrc/nw.cu) on the card under every block size
it takes, on the shapes of chip_smoke.py's phase ``nw``.

    python3 nw_sweep.py

On each shape D2 is first held against the native host tier (bit for
bit), then timed: device ms (the calls replayed from a CUDA graph) at 1, 2,
4 and 8 warps, a pair each, per block.  The shapes: fam100's 4,950 pairs,
8 random pairs of 2000 x 1980, and fam500's 124,750 pairs (the cells per
second the engine policy's NW_DEVICE_RATE comes from).  Prints one JSON
line per shape, then the card's name and power limit.  Run from two
checkouts in turns (parent, change, change, parent) to compare two versions
of the kernel on one card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import torch

from chip_smoke import (FIX, all_pairs, device_time, fasta_codes, nw_bound,
                        time_cuda)
from prographmsa_tpu_torch import _build, native
from prographmsa_tpu_torch.distances.align import GAP_PARAMS, _load_scoring
from prographmsa_tpu_torch.distances.nw_cuda import nw_counts, plan_nw


def main():
    if not torch.cuda.is_available():
        raise SystemExit("nw_sweep: torch.cuda.is_available() is false")
    dev = torch.device("cuda")
    _build.lib()
    aa = _load_scoring("aa")
    go, ge = GAP_PARAMS["aa"]
    rng = np.random.default_rng(23)
    shapes = {
        "fam100": all_pairs(*fasta_codes(FIX + "/fam100.fasta")),
        "8x2000x1980": (rng.integers(0, 21, (8, 2000)).astype(np.uint8),
                        rng.integers(0, 21, (8, 1980)).astype(np.uint8),
                        np.full(8, 2000, np.int32),
                        np.full(8, 1980, np.int32)),
        "fam500": all_pairs(*fasta_codes(FIX + "/fam500.fasta")),
    }
    for name, (s1, s2, l1, l2) in shapes.items():
        args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                for a in (s1, s2, l1, l2, aa)]
        ref = min(4096, len(l1))
        c, g = nw_counts(*(a[:ref] for a in args[:4]), args[4], go, ge, 20)
        cn, gn = native.nw_counts_native(s1[:ref], s2[:ref], l1[:ref],
                                         l2[:ref], aa, go, ge, 20)
        if not (np.array_equal(c.cpu().numpy(), cn)
                and np.array_equal(g.cpu().numpy(), gn)):
            raise AssertionError("%s: D2 differs from the native tier" % name)
        cells = int((l1.astype(np.int64) * l2).sum())
        row = {"shape": name, "pairs": len(l1), "cells": cells,
               "bound_ms": nw_bound(l1, l2, 21, 20, 1)[0]}
        reps = 10 if cells < 1e9 else 2
        for warps in (1, 2, 4, 8):
            plan = plan_nw(len(l1), 21, s1.shape[1], s2.shape[1], 20,
                           warps=warps)
            kern = lambda: nw_counts(*args, go, ge, 20, plan=plan)
            row["device_ms_w%d" % warps] = min(device_time(kern, reps)
                                               for _ in range(2))
        own = plan_nw(len(l1), 21, s1.shape[1], s2.shape[1], 20)
        kern = lambda: nw_counts(*args, go, ge, 20, plan=own)
        row["ms"] = min(time_cuda(kern, reps) for _ in range(2))
        row["cells_per_s"] = cells / (row["device_ms_w%d" % own.warps] / 1e3)
        print(json.dumps(row), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    print(os.path.abspath(_build.so_path()), file=sys.stderr)


if __name__ == "__main__":
    main()
