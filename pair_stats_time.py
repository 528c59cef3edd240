"""Device time of kernel D1 (the prealigned pair statistics) of the port in
a given source tree, on alignments saved as .npz files (arrays vals, gapm,
pi, pj and cb), timed as chip_smoke.py times device_ms: the wrapper's calls
captured in a CUDA graph and replayed between two events.

    python3 pair_stats_time.py [--check] TREE NAME=FILE.npz [...]

TREE is the root of a checkout of this repository: its
``prographmsa_tpu_torch`` is imported and its kernels are built there.
With --check, D1 is first held against that tree's own plain version
(pair_stats_torch) on each alignment, bit for bit.  Prints one JSON line,
{NAME: device ms}, the lower of two readings, and under "registers" the
registers a thread of each of the tree's pair kernels takes (ptxas), where
the tree's kernels were built in this process.
``chip_smoke.py --parent DIR`` runs it on an earlier tree in a process of
its own, so that the two trees' D1 are timed on one card in one call.
"""

from __future__ import annotations

import json
import os
import re
import sys

import numpy as np
import torch

REPS = 20


def device_time(fn, reps):
    """chip_smoke.device_time, copied: importing chip_smoke would import
    the port of this script's own tree, not TREE's."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    g.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def main():
    if not torch.cuda.is_available():
        raise SystemExit("pair_stats_time: torch.cuda.is_available() is "
                         "false")
    argv = sys.argv[1:]
    check = argv[0] == "--check"
    tree = os.path.abspath(argv[check])
    sys.path.insert(0, tree)
    import prographmsa_tpu_torch
    from prographmsa_tpu_torch import _build
    from prographmsa_tpu_torch.distances.prealigned_cuda import (
        pair_stats, pair_stats_torch)

    if not prographmsa_tpu_torch.__file__.startswith(tree + os.sep):
        raise SystemExit("pair_stats_time: imported %s, not the tree %s"
                         % (prographmsa_tpu_torch.__file__, tree))
    _build.lib()
    out = {"registers": dict(re.findall(
        r"entry function '[^']*?\d(pair_(?:pack|stats)_kernel(?:I\w)?)"
        r"[^']*'.*?Used (\d+) registers",
        _build.build_info.get("ptxas", ""), re.S))}
    for arg in argv[check + 1:]:
        name, path = arg.split("=", 1)
        z = np.load(path)
        args = [torch.from_numpy(z[k]).cuda()
                for k in ("vals", "gapm", "pi", "pj")]
        cb = int(z["cb"])
        if check:
            for got, want in zip(pair_stats(*args, cb),
                                 pair_stats_torch(*args, cb)):
                if not torch.equal(got.long(), want.long()):
                    raise SystemExit("pair_stats_time: %s: D1 of %s differs "
                                     "from its plain version" % (name, tree))
        out[name] = min(device_time(lambda: pair_stats(*args, cb), REPS)
                        for _ in range(2))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
