"""Sweep of the match-score kernel K2 over its layouts on one NVIDIA card.

    python3 k2_sweep.py

First holds K2 under every layout against its plain version
(chip_smoke.phase_s).  Then, from nvcc's report, the registers and spill
bytes of every compiled variant of ``s_kernel`` (one per width of states).
Then K2's device time (CUDA graph replay, the lower of two readings) under
rows per block x diagonals per block on fam100's largest level, eight
2000 x 1980 chains and fam500's root pair, with the plan
``scores_cuda.plan_s`` chooses and its time; and on random inputs of 4, 23,
61 and 64 states (12 pairs of 301 x 301) and of narrow planes (40 and 72
rows), where blocks of 128 rows are mostly padding.  One line per shape:
``t<rows>_d<diagonals>`` and milliseconds, then what the write of the whole array costs: K2 with every tile outside the
band (``all_tiles_outside``) and one ``fill_`` of an array of that size
(``torch_fill_``).  The SASS of the protein variant goes to
chiprun_out/s_sass.txt.  The constants of ``plan_s`` were read off this
table.  The last lines are the
card's name and power limit and SWEEP OK.
"""

from __future__ import annotations

import json
import os
import re
import tempfile

import numpy as np
import torch

import chip_smoke as cs
from prographmsa_tpu_torch import _build, checks
from prographmsa_tpu_torch.align.scores_cuda import (
    S_DTILES, S_SMEM_MAX, S_THREADS, plan_s, s_plane, s_prep, s_smem_bytes)

REPS = 10


def shapes(dev):
    """name -> K2's arguments at the three measured shapes."""
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
    out = {}
    for name, items in (("fam100_level", max(l100, key=len)),
                        ("8x2000x1980", chains), ("fam500_root", l500[-1])):
        _, bt = cs.pack(items, dev)
        t2, v2 = s_prep(bt.g2T, bt.M, bt.pi)
        out[name] = (bt.g1T, t2, v2, bt.pi, bt.mi, bt.n1, bt.n2)
    return out


def registers():
    """nvcc's line for each compiled variant of s_kernel."""
    log = _build.build_info.get("ptxas", "")
    rows = []
    for m in re.finditer(r"Compiling entry function '\w*[0-9]s_kernelILi(\d+)"
                         r"EE\w*'.*?\n.*?\n.*?(\d+) bytes stack "
                         r"frame, (\d+) bytes spill stores, (\d+) bytes spill "
                         r"loads\n.*?Used (\d+) registers", log):
        rows.append("dim%s: %s stack, %s+%s spill bytes, %s registers"
                    % m.groups())
    return rows


def dump_sass():
    """SASS of the protein variant (20 states) to
    chiprun_out/s_sass.txt; prints its opcode counts."""
    block = cs.kernel_sass(r"[0-9]s_kernelILi20EE", "s_sass.txt")
    ops = re.findall(r"^\s+/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\d\s+)?"
                     r"([A-Z][A-Z0-9_]*)", block, re.M)
    count = {}
    for op in ops:
        count[op] = count.get(op, 0) + 1
    print("s_kernel<20> SASS opcodes", len(ops), json.dumps(
        dict(sorted(count.items(), key=lambda kv: -kv[1])[:14]),
        separators=(",", ":")), flush=True)


def sweep(args, threads, dtiles):
    B, dim, n1max = args[0].shape
    n2max = args[1].shape[2]
    own = plan_s(B, dim, n1max, n2max)
    ms = {}
    for t in threads:
        for d in dtiles:
            if s_smem_bytes(dim, t, d) > S_SMEM_MAX:
                continue
            pl = plan_s(B, dim, n1max, n2max, threads=t, dtile=d)
            ms["t%d_d%d" % (t, d)] = round(min(
                cs.device_time(lambda: s_plane(*args, plan=pl), REPS)
                for _ in range(2)), 5)
    own_ms = min(cs.device_time(lambda: s_plane(*args), REPS)
                 for _ in range(2))
    # what the write of the whole array costs: every tile outside the band
    # (no pair has a row), and one fill_ of an array of that size
    dead = args[:5] + (torch.zeros_like(args[5]), args[6])
    ms["all_tiles_outside"] = round(min(
        cs.device_time(lambda: s_plane(*dead), REPS) for _ in range(2)), 5)
    Sd = s_plane(*args)
    ms["torch_fill_"] = round(min(
        cs.device_time(lambda: Sd.fill_(-1e37), REPS) for _ in range(2)), 5)
    ms["array_bytes"] = Sd.numel() * 4
    return own, own_ms, ms


def main():
    _, smi = cs.phase_device()
    dev = torch.device("cuda")
    cs.phase_build()
    cs.phase_s(dev)
    os.makedirs(cs.OUT, exist_ok=True)
    with open(os.path.join(cs.OUT, "k2_ptxas.txt"), "w") as f:
        f.write(_build.build_info.get("ptxas", ""))
    print("\n".join(registers()), flush=True)
    dump_sass()
    cj = lambda d: json.dumps(d, separators=(",", ":"))
    for name, args in shapes(dev).items():
        own, own_ms, ms = sweep(args, S_THREADS, (8, 16, 32, 64, 128))
        print(name, "B=%d n1max=%d n2max=%d" % (
            args[0].shape[0], args[0].shape[2], args[1].shape[2]),
            "plan=%s plan_ms=%.5f" % (cj(own._asdict()), own_ms), cj(ms),
            flush=True)
    rng = np.random.RandomState(9)
    for dim, B, n1, n2 in ((4, 12, 301, 301), (23, 12, 301, 301),
                           (61, 12, 301, 301), (64, 12, 301, 301),
                           (20, 64, 40, 300), (20, 500, 40, 36),
                           (20, 24, 72, 300), (20, 1, 40, 2000)):
        args = cs.s_inputs(rng, dim, n1, n2, (n1,) * B, (n2,) * B, dev)
        own, own_ms, ms = sweep(args, S_THREADS, S_DTILES)
        print("%dx%dx%d_dim%d" % (B, n1, n2, dim),
              "plan=%s plan_ms=%.5f" % (cj(own._asdict()), own_ms), cj(ms),
              flush=True)
    print(smi)
    print("SWEEP OK")


if __name__ == "__main__":
    main()
