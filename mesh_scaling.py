"""Scale-out of the PyTorch/CUDA port over the cards this host shows: the
counterpart of tools/scaling_bench.py on real cards.

    python3 mesh_scaling.py

With N visible cards (N > 1 for the splits to mean anything):

1. ``split``: fam500's 124,750 NW pairs (S1, ``sharded_nw_counts``) and
   fam500 -i 0's 16 level batches (``align_pairs_device``) over meshes of
   the first k = 1 .. N cards, each held against the unsplit work on
   cuda:0 (counts bit for bit; mappings, score bits and n_tr_indels),
   timed in turns there and back: S1's wall on the host's clock (uploads,
   fetches and the gather included), the levels' ``dp_device``.
2. ``cli``: c2_fam100 through the port's CLI as a user runs it here, every
   card visible (the level mesh is then all N: engine_policy.level_mesh),
   and with CUDA_VISIBLE_DEVICES=0 (one card, the unsplit path); each
   against the golden, stdout and stderr, with both walls.
3. ``procs``: fam500 --nwdist -i 0 in N processes of one cluster, one card
   each (CUDA_VISIBLE_DEVICES=r), against one process on one card and
   ``--engine native``: output, stderr less the join line, counters; the
   walls side by side.

Prints one line per part and the card's name and power limit; the
processes' --timings reports go to mesh_scaling.txt in chip_smoke.py's
output directory (``OUT``).  Every part raises on a difference.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

import chip_smoke as cs
from prographmsa_tpu_torch.distances.align import GAP_PARAMS, _load_scoring
from prographmsa_tpu_torch.distances.nw_cuda import nw_counts
from prographmsa_tpu_torch.parallel.mesh import make_mesh
from prographmsa_tpu_torch.parallel.sharded import sharded_nw_counts


def cli(args, out, env=None):
    """(wall, stderr) of the port's CLI on the card with --timings."""
    t0 = time.perf_counter()
    p = subprocess.run(
        [sys.executable, "-m", "prographmsa_tpu_torch.cli", *args,
         "--device", "cuda", "--timings", "-o", out], cwd=cs.REPO,
        capture_output=True, text=True, timeout=900,
        env=dict(os.environ, **(env or {})))
    if p.returncode != 0:
        raise AssertionError("%s exited %d: %s" % (args, p.returncode,
                                                   p.stderr[-3000:]))
    return time.perf_counter() - t0, p.stderr


def part_split(n, tmp, smi):
    t0 = time.perf_counter()
    cuda0 = torch.device("cuda", 0)
    aa = _load_scoring("aa")
    go, ge = GAP_PARAMS["aa"]
    arrs = cs.all_pairs(*cs.fasta_codes(cs.FIX + "/fam500.fasta"))
    t = lambda a: torch.from_numpy(a).to(cuda0)
    (c0, g0), _ = cs.host_ms(lambda: [x.cpu().numpy() for x in nw_counts(
        *map(t, arrs), t(aa), go, ge, 20)])
    ks = list(range(1, n + 1))
    s1_ms = {k: [] for k in ks}
    for k in ks + ks[::-1]:
        (c, g), ms = cs.host_ms(lambda: sharded_nw_counts(
            make_mesh(k), *arrs, aa, go, ge, 20))
        if not (np.array_equal(c, c0) and np.array_equal(g, g0)):
            raise AssertionError("S1 over %d cards differs from D2 unsplit"
                                 % k)
        s1_ms[k].append(ms)
    levels = []
    cs.run_port(["--fasta", "-i", "0", cs.FIX + "/fam500.fasta", "--engine",
                 "torch", "--device", "cuda", "-o",
                 os.path.join(tmp, "l500.fasta")], levels)
    meshes = {"unsplit": None}
    meshes.update({"%d_cards" % k: make_mesh(k) for k in ks})
    secs = cs.mesh_batches(levels, cuda0, meshes, turns=2)
    cs.say("split", t0, cards=n, s1_pairs=len(g0), s1="bit-identical",
           levels_fam500=len(levels), levels="identical",
           s1_wall_ms="{%s}" % ",".join("%d:%.3f" % (k, min(v))
                                        for k, v in s1_ms.items()),
           dp_device_s_levels_fam500=json.dumps(secs, separators=(",", ":")),
           card=repr(smi))


def part_cli(n, tmp, smi):
    t0 = time.perf_counter()
    args = ["--fasta", "--mldist", "--nwdist", cs.FIX + "/fam100.fasta"]
    with open(cs.GOLD + "/c2_fam100.stderr") as f:
        golden_err = f.read()
    walls, ctr = {}, {}
    for name, env in (("all_cards", {}),
                      ("one_card", {"CUDA_VISIBLE_DEVICES": "0"})):
        out = os.path.join(tmp, "c2_%s.fasta" % name)
        walls[name], err = cli(args, out, env)
        if not cs.same_file(out, cs.GOLD + "/c2_fam100.fasta"):
            raise AssertionError("c2_fam100 (%s) differs from the golden"
                                 % name)
        if cs.before_timings(err) != golden_err:
            raise AssertionError("c2_fam100 (%s): stderr differs from the "
                                 "golden" % name)
        ctr[name] = cs.counters_of(err)
        cs.note("== c2_fam100, %s --timings" % name, err)
    if ctr["all_cards"] != ctr["one_card"]:
        raise AssertionError("c2_fam100: counters differ: %s" % ctr)
    cs.say("cli", t0, cards=n, run="c2_fam100", golden="stdout+stderr",
           wall_all_cards_s="%.3f" % walls["all_cards"],
           wall_one_card_s="%.3f" % walls["one_card"], card=repr(smi))


def part_procs(n, tmp, smi):
    t0 = time.perf_counter()
    args = ["--fasta", "--nwdist", "-i", "0", cs.FIX + "/fam500.fasta"]
    one = {"out": os.path.join(tmp, "nw500.one"),
           "ref": os.path.join(tmp, "nw500.native")}
    one["wall"], one["err"] = cli(args, one["out"],
                                  {"CUDA_VISIBLE_DEVICES": "0"})
    subprocess.run([sys.executable, "-m", "prographmsa_tpu_torch.cli",
                    *args, "--engine", "native", "-o", one["ref"]],
                   cwd=cs.REPO, check=True, timeout=900,
                   capture_output=True)
    wall, outs = cs.processes(
        "nw500", args, tmp, n, lambda r: {"CUDA_VISIBLE_DEVICES": str(r)})
    cs.check_processes("fam500_nwdist_i0", outs, one)
    cs.note("== fam500 --nwdist -i 0, one process", one["err"],
            *("== process %d of %d\n%s" % (r, n, err)
              for r, (_, err) in enumerate(outs)))
    cs.say("procs", t0, processes=n, run="fam500_nwdist_i0",
           identical="stdout+stderr+counters",
           wall_n_procs_s="%.3f" % wall, wall_1proc_s="%.3f" % one["wall"],
           dp_device_s="%s/%s" % (cs.timing_of(outs[0][1], "dp_device"),
                                  cs.timing_of(one["err"], "dp_device")),
           distances_s="%s/%s" % (cs.timing_of(outs[0][1], "distances"),
                                  cs.timing_of(one["err"], "distances")),
           card=repr(smi))


def main():
    name, smi = cs.phase_device()
    cs.phase_build()
    n = torch.cuda.device_count()
    os.makedirs(cs.OUT, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=cs.OUT) as tmp:
        part_split(n, tmp, smi)
        part_cli(n, tmp, smi)
        part_procs(n, tmp, smi)
    with open(os.path.join(cs.OUT, "mesh_scaling.txt"), "w") as f:
        f.write("\n".join(cs.detail) + "\n")
    print(smi)


if __name__ == "__main__":
    main()
