"""Times the NW kernel D2 (csrc/nw.cu) on the card under every layout it
is compiled for, on the shapes of chip_smoke.py's phase ``nw``.

    python3 nw_sweep.py

On each shape every layout is first held against the native host tier on
the shape's first 4,096 pairs (bit for bit), then timed: device ms (the
calls replayed from a CUDA graph) at R = 1, 2 and 4 rows a lane x 1, 2, 4
and 8 warps, a pair each, per block; then at the planned layout
(``plan_nw``: R = 4, 8 warps where the pairs fill the card) the
fill-only variant (no walk back), whose time against the whole kernel's
gives the walk's share.  The shapes: fam100's 4,950 pairs, 8 random pairs
of 2000 x 1980, and fam500's 124,750 pairs (the cells per second the
engine policy's NW_DEVICE_RATE comes from).  Prints the DPX rates the
bound takes, one JSON line per shape, then the card's name and power
limit.  Run from two checkouts in turns (parent, change, change, parent)
to compare two versions of the kernel on one card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import torch

from chip_smoke import (FIX, all_pairs, device_time, dpx_rates, fasta_codes,
                        nw_bound, time_cuda)
from prographmsa_tpu_torch import _build, native
from prographmsa_tpu_torch.distances.align import GAP_PARAMS, _load_scoring
from prographmsa_tpu_torch.distances.nw_cuda import ROWS, nw_counts, plan_nw


def main():
    if not torch.cuda.is_available():
        raise SystemExit("nw_sweep: torch.cuda.is_available() is false")
    dev = torch.device("cuda")
    _build.lib()
    aa = _load_scoring("aa")
    rng_aa = (aa.min(), aa.max())
    go, ge = GAP_PARAMS["aa"]
    dpx = dpx_rates()
    print(json.dumps({"dpx_ops_s": dpx}), flush=True)
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
        B, L1, L2 = len(l1), s1.shape[1], s2.shape[1]
        ref = min(4096, B)
        cn, gn = native.nw_counts_native(s1[:ref], s2[:ref], l1[:ref],
                                         l2[:ref], aa, go, ge, 20)
        cells = int((l1.astype(np.int64) * l2).sum())
        bound, by, old = nw_bound(l1, l2, 21, 20, 1, dpx)
        row = {"shape": name, "pairs": B, "cells": cells, "bound_ms": bound,
               "bound_by": by, "bound_old_ms": old}
        reps = 10 if cells < 1e9 else 2
        for R in ROWS:
            for warps in (1, 2, 4, 8):
                plan = plan_nw(B, 21, L1, L2, 20, rng_aa, warps=warps,
                               rows=R)
                c, g = nw_counts(*(a[:ref] for a in args[:4]), args[4], go,
                                 ge, 20, plan=plan)
                if not (np.array_equal(c.cpu().numpy(), cn)
                        and np.array_equal(g.cpu().numpy(), gn)):
                    raise AssertionError("%s: D2 at R=%d, %d warps differs "
                                         "from the native tier"
                                         % (name, R, warps))
                kern = lambda: nw_counts(*args, go, ge, 20, plan=plan)
                row["device_ms_R%d_w%d" % (R, warps)] = min(
                    device_time(kern, reps) for _ in range(2))
        own = plan_nw(B, 21, L1, L2, 20, rng_aa)
        kern = lambda: nw_counts(*args, go, ge, 20, plan=own)
        fill = lambda: nw_counts(*args, go, ge, 20,
                                 plan=own._replace(walk=False))
        row["rows"], row["warps"] = own.rows, own.warps
        row["ms"] = min(time_cuda(kern, reps) for _ in range(2))
        row["device_ms"] = min(device_time(kern, reps) for _ in range(2))
        row["fill_only_device_ms"] = min(device_time(fill, reps)
                                         for _ in range(2))
        row["walk_share"] = 1 - row["fill_only_device_ms"] / row["device_ms"]
        row["cells_per_s"] = cells / (row["device_ms"] / 1e3)
        row["share_of_bound"] = bound / row["device_ms"]
        print(json.dumps(row), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    print(os.path.abspath(_build.so_path()), file=sys.stderr)


if __name__ == "__main__":
    main()
