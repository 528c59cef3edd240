"""Sweep of the wavefront fill K3 over its layouts on one NVIDIA card.

    python3 k3_sweep.py

Times ``fill_cuda.fill`` under every cluster size the card can hold (1 to
16 blocks per pair; 16 is the non-portable size) and every number of lanes per cell that the
layout allows, on fam100's largest level, eight 2000 x 1980 chains and
levels 0, 3, 6, 9 and 12 to 15 of the fam500 ``-i 0`` pass.  One line per
shape: pairs, largest n1, ring diagonals, mean match candidates per cell,
the mean over diagonals of the most candidates one cell has, the plan ``fill_cuda.plan_fill`` chooses, then milliseconds per layout
(``C<blocks>_l<lanes>``, a trailing ``g`` where the rings do not fit shared
memory and stay in global memory).  The constants of ``plan_fill`` were
read off this table.  Levels 12 and 15 are first held against
``fill_torch`` under the widest and a 4-block layout.  The last lines are
the card's name and power limit and SWEEP OK.
"""

from __future__ import annotations

import json
import os
import tempfile

import numpy as np
import torch

import chip_smoke as cs
from prographmsa_tpu_torch import checks
from prographmsa_tpu_torch.align import graph_dp_cuda as gdp
from prographmsa_tpu_torch.align.fill_cuda import SMS, fill, plan_fill

LEVELS = (0, 3, 6, 9, 12, 13, 14, 15)
CHECKED = (12, 15)


def shapes():
    os.makedirs(cs.OUT, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=cs.OUT) as tmp:
        l500, l100 = [], []
        cs.run_port(["--fasta", "-i", "0", cs.FIX + "/fam500.fasta",
                     "--engine", "torch", "--device", "cuda", "-o",
                     os.path.join(tmp, "l500.fasta")], l500)
        cs.run_port(["--fasta", "-t", cs.GOLD + "/tree0_fam100.nwk",
                     cs.FIX + "/fam100.fasta", "--engine", "torch",
                     "--device", "cuda", "-o",
                     os.path.join(tmp, "t100.fasta")], l100)
    rng = np.random.RandomState(3)
    m = checks.model(0.5)
    chains, _ = checks.items_and_expected(
        [(checks.chain(checks.random_seq(rng, 2000)),
          checks.chain(checks.random_seq(rng, 1980)), m) for _ in range(8)])
    out = {"fam100_level": max(l100, key=len), "8x2000x1980": chains}
    out.update(("fam500_L%d" % lv, l500[lv]) for lv in LEVELS)
    return out


def worst_cell(p):
    """Mean over the diagonals of a pair of the most match candidates any
    one cell of the diagonal has (in-degree of y times in-degree of x): the
    cell whose scan a diagonal waits for."""
    k1 = np.count_nonzero(p.C1 < gdp.COST_INF, axis=1)
    k2 = np.count_nonzero(p.C2 < gdp.COST_INF, axis=1)
    prod = np.outer(k1, k2)[:, ::-1]
    n1, n2 = prod.shape
    return float(np.mean([prod.diagonal(k).max()
                          for k in range(-(n1 - 1), n2)]))


def main():
    _, smi = cs.phase_device()
    dev = torch.device("cuda")
    cs.phase_build()
    for name, items in shapes().items():
        preps, bt = cs.pack(items, dev)
        Sd = gdp.exact_s(bt.g1T, bt.g2T, bt.M, bt.pi, bt.mi, bt.n1, bt.n2)
        fa = cs.fill_args(Sd, bt)
        B, _, n1max = bt.g1T.shape
        if name in ["fam500_L%d" % lv for lv in CHECKED]:
            cs.fill_check(Sd, bt, [
                bt.plan,
                plan_fill(B, n1max, bt.Rmax, lanes=16,
                          blocks_per_pair=max(cs.cluster_sizes(dev))),
                plan_fill(B, n1max, bt.Rmax, blocks_per_pair=4, lanes=2)])
        ms = {}
        for C in cs.cluster_sizes(dev):
            if B * C > 4 * SMS:
                continue
            for lanes in (1, 2, 4, 8, 16, 32):
                pl = plan_fill(B, n1max, bt.Rmax, blocks_per_pair=C,
                               lanes=lanes)
                if pl.lanes != lanes:
                    continue
                key = "C%d_l%d%s" % (C, lanes, "" if pl.smem_rings else "g")
                ms[key] = round(cs.time_cuda(lambda: fill(*fa, pl), 3), 3)
        print(name, "B=%d n1max=%d Rmax=%d cands=%.2f worst_cell=%.1f plan=%s"
              % (B, n1max, bt.Rmax,
                 max(gdp._cands_per_cell(p) for p in preps),
                 max(worst_cell(p) for p in preps),
                 json.dumps(bt.plan._asdict(), separators=(",", ":"))),
              json.dumps(ms, separators=(",", ":")), flush=True)
    print(smi)
    print("SWEEP OK")


if __name__ == "__main__":
    main()
