"""Smoke check of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from csrc/ with nvcc and its C++ host tier
with g++, holds each kernel against its plain PyTorch version and the host
oracles, drives the port's CLI main path (fam100 fixed tree and free tree,
fam500 one pass) against the goldens and the port's own ``--engine native``
run on the same host, and times every kernel beside its plain version, its
roofline bound and, where one PyTorch call computes the same function, that
call.  Every phase raises on failure; there is no CPU fallback.  One line
per phase, then one JSON line of kernels, the card's name and power limit,
and last {"ok": true, "device": {...}}.  Long output goes to chiprun_out/.

The bound of a kernel is the larger of its bytes (each input read once,
each output written once, the pairs' own cells only) over HBM_BYTES_S and
its float32 operations over F32_FLOPS, the H100 SXM's published peaks.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from prographmsa_tpu_torch import _build, checks, native, timings
from prographmsa_tpu_torch import cli as port_cli
from prographmsa_tpu_torch.align import graph_dp_cuda as gdp
from prographmsa_tpu_torch.align.chase_cuda import (META_LEN, chase,
                                                    chase_torch, row_width)
from prographmsa_tpu_torch.align.fill_cuda import (card_limits, fill,
                                                   fill_torch, plan_fill)
from prographmsa_tpu_torch.align.slots import COST_INF
from prographmsa_tpu_torch.align.scores_cuda import (
    s_plane, s_plane_torch, s_prep, s_prep_torch, unshear)

REPO = os.path.dirname(os.path.abspath(__file__))
FIX = os.path.join(REPO, "fixtures")
GOLD = os.path.join(FIX, "golden")
OUT = os.path.join(REPO, "chiprun_out")

KERNELS = {
    "s_prep": ("prographmsa_tpu_torch/csrc/scores.cu",
               "prographmsa_tpu/align/scores_pallas.py:59"),
    "s": ("prographmsa_tpu_torch/csrc/scores.cu",
          "prographmsa_tpu/align/scores_pallas.py:99"),
    "fill": ("prographmsa_tpu_torch/csrc/fill.cu",
             "prographmsa_tpu/align/graph_dp_pallas.py:276"),
    "chase": ("prographmsa_tpu_torch/csrc/chase.cu",
              "prographmsa_tpu/align/graph_dp_pallas.py:887"),
}
max_err = {k: 0.0 for k in KERNELS}
detail = []
HBM_BYTES_S = 3.35e12          # H100 SXM device memory rate
F32_FLOPS = 67e12              # H100 SXM float32 outside the tensor cores


def say(phase, t0, **kv):
    kv = " ".join("%s=%s" % (k, v) for k, v in kv.items())
    print("%-14s %8.2f s  %s" % (phase, time.perf_counter() - t0, kv),
          flush=True)


def note(*lines):
    detail.extend(lines)


def diff(kernel, a, b, name):
    """Record max |a - b| for ``kernel``; raise unless bit-identical."""
    if a.dtype.is_floating_point:
        ok = torch.equal(a.view(torch.int32), b.view(torch.int32))
        err = (a.double() - b.double()).abs().nan_to_num(float("inf"))
    else:
        ok = torch.equal(a, b)
        err = (a.long() - b.long()).abs().double()
    m = float(err.max()) if err.numel() else 0.0
    max_err[kernel] = max(max_err[kernel], 0.0 if ok else m)
    if not ok:
        raise AssertionError("%s: %s differs from its plain version "
                             "(max abs %g, %d positions)"
                             % (kernel, name, m, int((err != 0).sum())))


def pack(items, dev):
    """(slot tables, batch tensors on ``dev``) of device-eligible items."""
    preps = [gdp.prep_pair(k, *it) for k, it in enumerate(items)]
    if any(isinstance(p, str) for p in preps):
        raise AssertionError("a pair left the device path: %s" % preps)
    return preps, gdp.pack_pairs(preps, dev)


def s_check(bt):
    t2, v2 = s_prep(bt.g2T, bt.M, bt.pi)
    t2p, v2p = s_prep_torch(bt.g2T, bt.M, bt.pi)
    diff("s_prep", t2, t2p, "t2")
    diff("s_prep", v2, v2p, "v2")
    Sd = s_plane(bt.g1T, t2, v2, bt.pi, bt.mi, bt.n1, bt.n2)
    diff("s", Sd, s_plane_torch(bt.g1T, t2, v2, bt.pi, bt.mi, bt.n1, bt.n2),
         "Sdiag")
    return Sd


def fill_args(Sd, bt):
    return (Sd, bt.O1, bt.O2, bt.C1T, bt.C2T, bt.iv, bt.par, bt.Rmax)


def cluster_sizes(dev):
    """The blocks per pair this card can run K3 with."""
    return [C for C in (1, 2, 4, 8, 16) if C <= card_limits(dev)[1]]


def fill_layouts(bt):
    """The launch's own plan and every other layout of K3 worth holding
    against the plain version: each cluster size, 1 to 32 lanes per cell,
    and the rings in global memory instead of shared memory."""
    B, _, n1max = bt.g1T.shape
    plans = [bt.plan]
    for C in cluster_sizes(bt.g1T.device):
        for lanes in (1, 4, 32):
            plans.append(plan_fill(B, n1max, bt.Rmax, blocks_per_pair=C,
                                   lanes=lanes))
    for p in (plans[1], plans[-1]):
        band = -(-n1max // p.blocks_per_pair)
        plans.append(p._replace(smem_rings=False, smem_bytes=2 * band * 4))
    return plans


def fill_check(Sd, bt, layouts=None):
    """K3 under each layout against fill_torch, whole planes, bit for bit.
    Returns (the output under the launch's own plan, layouts checked)."""
    fp = fill_torch(*fill_args(Sd, bt))
    layouts = list(dict.fromkeys(fill_layouts(bt) if layouts is None
                                 else layouts))
    first = None
    for plan in layouts:
        fo = fill(*fill_args(Sd, bt), plan)
        torch.cuda.synchronize()
        for name, a, b in zip(fo._fields, fo, fp):
            diff("fill", a, b, "%s under %s" % (name, plan))
        first = fo if first is None else first
    return first, len(layouts)


def phase_device():
    t0 = time.perf_counter()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()
    name = torch.cuda.get_device_name(0)
    say("device", t0, name=repr(name), count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda)
    return name, smi[0] if smi else "nvidia-smi: no output"


def phase_build():
    t0 = time.perf_counter()
    so = _build.build()
    _build.lib()
    note("== nvcc -Xptxas -v", _build.build_info.get("ptxas", "(cached)"))
    t1 = time.perf_counter()
    if not native.available():
        raise AssertionError("the port's native host library (g++, "
                             "native/graphcore.cpp) did not build")
    say("build", t0, nvcc_s="%.2f" % _build.build_info["seconds"],
        lib=os.path.basename(so), native_s="%.2f" % (time.perf_counter() - t1),
        native_lib=os.path.basename(native._SO))


def phase_s(dev):
    t0 = time.perf_counter()
    rng = np.random.RandomState(11)
    m = checks.model(0.4)
    pairs = [(checks.chain(checks.random_seq(rng, 100 + 53 * k)),
              checks.chain(checks.random_seq(rng, 90 + 61 * k)), m)
             for k in range(4)]
    s_long = checks.random_seq(rng, 190)
    cg = checks.merged(s_long, checks.mutated(rng, s_long, 12), m)
    pairs += [(cg, pairs[0][0], m), (pairs[1][1], cg, m)]
    big = [(checks.chain(checks.random_seq(rng, 2000)),
            checks.chain(checks.random_seq(rng, 1980)), m)]
    n_cells = 0
    for group in (pairs, big):
        items, _ = checks.items_and_expected(group)
        _, bt = pack(items, dev)
        Sd = s_check(bt)
        for b, (g1, g2, mm, sc) in enumerate(items):
            Sh = checks.precompute_scores(g1, g2, mm, sc, engine="numpy")
            Sk = unshear(Sd, g1.size, g2.size, b)
            if not np.array_equal(Sh.view(np.uint32), Sk.view(np.uint32)):
                raise AssertionError("S of pair %d differs from the host "
                                     "precompute_scores" % b)
            n_cells += Sh.size
    say("s_kernel", t0, pairs=len(pairs) + 1, cells=n_cells,
        vs_host="bit-identical", vs_plain="bit-identical")


def fill_pairs():
    rng = np.random.RandomState(17)
    m = checks.model(0.5)
    pairs = [(checks.heavy(60, [2, 3, 5, 7, 11, 13, 17], 1),
              checks.heavy(55, [2, 3, 4, 6, 9], 2), m),
             (checks.heavy(48, [2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 19,
                                23], 3),
              checks.heavy(52, [2, 3, 5, 8, 13, 21, 34, 55], 4), m),
             (checks.many_offsets_graph(40, 18, 5),
              checks.chain(checks.random_seq(rng, 30)), m)]
    for seed in range(3):
        s_long = checks.random_seq(rng, 190)
        cg2 = checks.merged(s_long, checks.mutated(rng, s_long, 12),
                            checks.model(0.3))
        pairs.append((checks.chain(checks.random_seq(rng, 13)), cg2,
                      checks.model(0.3)))
    reps = [checks.repeat_pair(s) for s in range(4)]
    reps.append(checks.fixed_repeat_pair())
    # a level of one pair: two merged graphs against each other
    s_a, s_b = checks.random_seq(rng, 230), checks.random_seq(rng, 210)
    m3 = checks.model(0.3)
    single = [(checks.merged(s_a, checks.mutated(rng, s_a, 15), m3),
               checks.merged(s_b, checks.mutated(rng, s_b, 9), m3), m)]
    return pairs, reps, single


def phase_fill_chase(dev):
    pairs, reps, single = fill_pairs()
    groups = ((pairs, checks.OPTS), (reps, checks.REPEAT_OPTS),
              (single, checks.OPTS))
    n_pairs = n_rep = n_layouts = 0
    t1 = time.perf_counter()
    outs = []
    for group, opts in groups:
        items, expected = checks.items_and_expected(group, opts)
        _, bt = pack(items, dev)
        Sd = s_check(bt)
        fo, n = fill_check(Sd, bt)
        n_layouts += n
        outs.append((items, expected, bt, fo))
        n_pairs += len(items)
    say("fill_kernel", t1, pairs=n_pairs, layouts_checked=n_layouts,
        codes_rings_stripes="bit-identical")

    t1 = time.perf_counter()
    for items, expected, bt, fo in outs:
        args = (bt.O1, bt.O2, bt.C1T, bt.C2T, bt.R1T, bt.R2T, bt.iv, bt.par,
                bt.Lm)
        diff("chase", chase(fo, *args), chase_torch(fo, *args), "packed")
        res = gdp.align_pairs_device(items, dev)
        for k, (r, aln) in enumerate(zip(res, expected)):
            g1, g2, mm, sc = items[k]
            ref = checks.native_or_host(g1, g2, mm, sc, aln)
            if not checks.same_alignment(r, ref):
                raise AssertionError("pair %d: device alignment differs "
                                     "from the host" % k)
            n_rep += int(r[3] > 0)
    if n_rep == 0:
        raise AssertionError("no repeat event was exercised")
    say("chase_kernel", t1, pairs=n_pairs, pairs_with_repeat_events=n_rep,
        vs_plain="bit-identical", vs_native="mappings+score+n_tr identical")


def run_port(argv, record=None):
    """Port CLI in-process; returns (stderr text, timings counters).
    ``record``: a list that receives every level batch's items."""
    orig = gdp.align_pairs_device
    if record is not None:
        def wrapped(items, device):
            record.append(list(items))
            return orig(items, device)
        gdp.align_pairs_device = wrapped
    err = io.StringIO()
    try:
        with contextlib.redirect_stderr(err):
            rc = port_cli.main(argv)
    finally:
        gdp.align_pairs_device = orig
    if rc != 0:
        raise AssertionError("port CLI %s exited %d:\n%s"
                             % (argv, rc, err.getvalue()[-3000:]))
    return err.getvalue(), timings.counters()


def same_file(a, b):
    with open(a) as fa, open(b) as fb:
        return fa.read() == fb.read()


def check_counters(ctr, what):
    if ctr.get("torch_pairs_device", 0) != ctr.get("torch_pairs_total", -1):
        raise AssertionError("%s: pairs left the device: %s" % (what, ctr))
    fb = {k: v for k, v in ctr.items() if k.startswith("torch_fb_") and v}
    if fb:
        raise AssertionError("%s: fallbacks %s" % (what, fb))


def phase_fam100(dev, tmp):
    t0 = time.perf_counter()
    out = os.path.join(tmp, "t100.fasta")
    levels = []
    _build.reset_launches()
    _, ctr = run_port(["--fasta", "-t", GOLD + "/tree0_fam100.nwk",
                       FIX + "/fam100.fasta", "--engine", "torch",
                       "--device", "cuda", "--timings", "-o", out], levels)
    launches = dict(_build.LAUNCHES)
    if not same_file(out, GOLD + "/t_fam100.fasta"):
        raise AssertionError("t_fam100 differs from the golden")
    check_counters(ctr, "t_fam100")
    if not all(launches[k] > 0 for k in KERNELS):
        raise AssertionError("a kernel was not launched: %s" % launches)
    pairs_t = ctr["torch_pairs_total"]

    out2 = os.path.join(tmp, "c2.fasta")
    _build.reset_launches()
    err, ctr2 = run_port(["--fasta", "--mldist", "--nwdist",
                          FIX + "/fam100.fasta", "--engine", "torch",
                          "--device", "cuda", "--timings", "-o", out2])
    if not same_file(out2, GOLD + "/c2_fam100.fasta"):
        raise AssertionError("c2_fam100 differs from the golden")
    with open(GOLD + "/c2_fam100.stderr") as f:
        if err.split("timings (wall seconds")[0] != f.read():
            raise AssertionError("c2_fam100 stderr differs from the golden")
    check_counters(ctr2, "c2_fam100")
    if not all(_build.LAUNCHES[k] > 0 for k in KERNELS):
        raise AssertionError("c2: a kernel was not launched")
    say("fam100", t0, t_fam100="golden", c2_fam100="golden+stderr",
        pairs_per_pass=pairs_t, c2_pairs=ctr2["torch_pairs_total"],
        fb=0, launches=json.dumps(launches, separators=(",", ":")))
    return launches, max(levels, key=len)


def phase_levels(dev, tmp):
    """Kernel time of every level of the fam500 -i 0 pass (kernels only):
    which levels the device time goes to.  The root level, one pair of large
    merged graphs with hundreds of slot pairs, is held against fill_torch
    and the native tier under the layouts that spread a pair over SMs."""
    t0 = time.perf_counter()
    levels = []
    _build.reset_launches()
    run_port(["--fasta", "-i", "0", FIX + "/fam500.fasta", "--engine",
              "torch", "--device", "cuda", "-o",
              os.path.join(tmp, "l500.fasta")], levels)
    launches = dict(_build.LAUNCHES)
    if not all(launches[k] > 0 for k in KERNELS):
        raise AssertionError("fam500: a kernel was not launched: %s"
                             % launches)
    rows, total = [], {k: 0.0 for k in KERNELS}
    for lv, items in enumerate(levels):
        preps, bt = pack(items, dev)
        t2, v2 = s_prep(bt.g2T, bt.M, bt.pi)
        Sd = s_plane(bt.g1T, t2, v2, bt.pi, bt.mi, bt.n1, bt.n2)
        fo = fill(*fill_args(Sd, bt), bt.plan)
        ms = {
            "s_prep": time_cuda(lambda: s_prep(bt.g2T, bt.M, bt.pi), 3),
            "s": time_cuda(lambda: s_plane(bt.g1T, t2, v2, bt.pi, bt.mi,
                                           bt.n1, bt.n2), 3),
            "fill": time_cuda(lambda: fill(*fill_args(Sd, bt), bt.plan), 3),
            "chase": time_cuda(lambda: chase(fo, bt.O1, bt.O2, bt.C1T,
                                             bt.C2T, bt.R1T, bt.R2T, bt.iv,
                                             bt.par, bt.Lm), 3)}
        for k in KERNELS:
            total[k] += ms[k]
        slots = max(len(p.o1) * len(p.o2) for p in preps)
        nmax = max(max(p.g1.size, p.g2.size) for p in preps)
        rows.append((lv, len(items), nmax, slots, max(p.R for p in preps),
                     bt.plan, ms))
    note("== fam500 -i 0 levels: level pairs max_nodes max_slot_pairs "
         "max_R blocks_per_pair lanes threads smem_rings "
         "ms(s_prep s fill chase)")
    note(*("%2d %4d %5d %5d %4d %d %2d %4d %d  %.4f %.4f %.4f %.4f"
           % (lv, b, n, sl, r, pl.blocks_per_pair, pl.lanes, pl.threads,
              pl.smem_rings, *(ms[k] for k in KERNELS))
           for lv, b, n, sl, r, pl, ms in rows))
    top = sorted(rows, key=lambda r: -r[6]["fill"])[:3]
    say("levels:fam500", t0, levels=len(rows),
        launches=json.dumps(launches, separators=(",", ":")),
        kernel_ms_sum=json.dumps({k: round(v, 4) for k, v in total.items()},
                                 separators=(",", ":")),
        top_fill_levels=";".join("L%d:pairs=%d,nodes=%d,slot_pairs=%d,"
                                 "blocks_per_pair=%d,fill_ms=%.3f"
                                 % (r[0], r[1], r[2], r[3],
                                    r[5].blocks_per_pair, r[6]["fill"])
                                 for r in top))

    # the root level: one pair on many SMs, against the plain version (the
    # full pair, whole planes) and the native tier
    t0 = time.perf_counter()
    root = levels[-1]
    if len(root) != 1:
        raise AssertionError("fam500's root level holds %d pairs" % len(root))
    preps, bt = pack(root, dev)
    if bt.plan.blocks_per_pair < 2:
        raise AssertionError("the root pair was planned on one block: %s"
                             % (bt.plan,))
    Sd = s_check(bt)
    B, _, n1max = bt.g1T.shape
    fo, n = fill_check(Sd, bt, [bt.plan] + [
        plan_fill(B, n1max, bt.Rmax, blocks_per_pair=C, lanes=lanes)
        for C, lanes in ((max(cluster_sizes(dev)), 8), (8, 32), (4, 8),
                         (2, 1))])
    args = (bt.O1, bt.O2, bt.C1T, bt.C2T, bt.R1T, bt.R2T, bt.iv, bt.par,
            bt.Lm)
    diff("chase", chase(fo, *args), chase_torch(fo, *args), "root packed")
    g1, g2, mm, sc = root[0]
    res = gdp.align_pairs_device(root, dev)[0]
    ref = checks.native_align(g1, g2, mm, sc)
    if ref is None or not checks.same_alignment(res, ref):
        raise AssertionError("root pair: device alignment differs from the "
                             "native tier")
    p = preps[0]
    say("root_pair", t0, nodes="%dx%d" % (g1.size, g2.size),
        slot_pairs=len(p.o1) * len(p.o2), R=p.R,
        plan=json.dumps(bt.plan._asdict(), separators=(",", ":")),
        layouts_checked=n, vs_plain="bit-identical (full pair)",
        vs_native="mappings+score+n_tr identical")
    return launches, root


def cli_wall(args, out, extra=()):
    cmd = [sys.executable, "-m", "prographmsa_tpu_torch.cli", *args, *extra,
           "-o", out]
    t0 = time.perf_counter()
    p = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                       timeout=900)
    wall = time.perf_counter() - t0
    if p.returncode != 0:
        raise AssertionError("%s exited %d: %s" % (cmd, p.returncode,
                                                   p.stderr[-3000:]))
    return wall, p.stderr


def phase_walls(tmp):
    """fam100 (fixed tree) and fam500 (-i 0): the port on the card against
    its own --engine native on this host, as separate processes; then the
    start-up (imports, CUDA context) of each."""
    t0 = time.perf_counter()
    if not native.available():
        raise AssertionError("the port's native host library did not build: "
                             "--engine native would time the numpy tier")
    for name, args in (("t_fam100", ["--fasta", "-t",
                                     GOLD + "/tree0_fam100.nwk",
                                     FIX + "/fam100.fasta"]),
                       ("fam500_i0", ["--fasta", "-i", "0",
                                      FIX + "/fam500.fasta"])):
        o_port = os.path.join(tmp, name + ".port")
        o_nat = os.path.join(tmp, name + ".native")
        w_port, err = cli_wall(args, o_port, ("--engine", "torch",
                                              "--device", "cuda",
                                              "--timings"))
        w_nat, err_nat = cli_wall(args, o_nat, ("--engine", "native",
                                                "--timings"))
        if "dp_fused" not in err_nat:
            raise AssertionError("%s: --engine native did not run the C++ "
                                 "tier:\n%s" % (name, err_nat[-2000:]))
        if not same_file(o_port, o_nat):
            raise AssertionError("%s: port differs from --engine native"
                                 % name)
        ctr = {ln.split()[0]: int(ln.split()[1]) for ln in
               err.split("counters:")[-1].strip().splitlines()}
        check_counters(ctr, name)
        note("== %s port --timings" % name, err,
             "== %s native --timings" % name, err_nat)
        say(name, t0, port_s="%.3f" % w_port, native_s="%.3f" % w_nat,
            identical=True, pairs_device=ctr["torch_pairs_device"],
            pairs_total=ctr["torch_pairs_total"],
            **{k: ctr.get("torch_" + k, 0) for k in gdp.FALLBACK_KEYS
               if k.startswith("fb_")})
        t0 = time.perf_counter()
    startup = {}
    for name, code in (("port_import_and_cuda_init_s",
                        "import torch, prographmsa_tpu_torch.cli; "
                        "torch.zeros(1, device='cuda'); "
                        "torch.cuda.synchronize()"),
                       ("port_import_s", "import prographmsa_tpu_torch.cli")):
        t1 = time.perf_counter()
        subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                       timeout=300)
        startup[name] = "%.3f" % (time.perf_counter() - t1)
    say("startup", t0, **startup)


def time_cuda(fn, reps):
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def bounds(preps, packed, Lm):
    """Per kernel (bound_ms, bound_by) on these pairs: the larger of bytes
    over the memory rate and float32 operations over the peak rate, from
    the pairs' own sizes; the chase counts the cells its walks visited."""
    by = {k: 0.0 for k in KERNELS}
    op = {k: 0.0 for k in KERNELS}
    walk = packed[:, 2 * Lm + META_LEN]
    for k, p in enumerate(preps):
        n1, n2, dim = p.g1.size, p.g2.size, p.g1.dim
        e1 = int(np.count_nonzero(p.C1 < COST_INF))
        e2 = int(np.count_nonzero(p.C2 < COST_INF))
        nl1, nl2 = len(p.o1), len(p.o2)
        by["s_prep"] += 4 * (dim * n2 + dim * dim + dim + dim * n2 + n2)
        op["s_prep"] += 2 * n2 * dim * dim + 2 * n2 * dim
        by["s"] += 4 * (dim * n1 + dim * n2 + n2 + dim + 1 + n1 * n2)
        op["s"] += 2 * dim * n1 * n2 + 2 * dim * n1 + 12 * n1 * n2
        # S in, codes out, slot tables in, four rings and two stripes out
        by["fill"] += 4 * (2 * n1 * n2 + nl1 * n1 + nl2 * n2 + nl1 + nl2
                           + 4 * p.R * n1 + n1 + n2)
        # 3 per match candidate, 7 per edge of a Y or X move, 12 per cell
        op["fill"] += 3 * e1 * e2 + 7 * (e1 * n2 + e2 * n1) + 12 * n1 * n2
        steps = int(walk[k])
        by["chase"] += 4 * (row_width(Lm) + 3 * steps + 3 * p.R * nl1 * nl2)
        op["chase"] += 12 * nl1 * nl2 + 10 * steps
    out = {}
    for k in KERNELS:
        tb, to = by[k] / HBM_BYTES_S * 1e3, op[k] / F32_FLOPS * 1e3
        out[k] = (max(tb, to), "bytes" if tb >= to else "operations")
    return out


def kernel_times(items, dev, reps_kernel, reps_plain):
    preps, bt = pack(items, dev)
    t2, v2 = s_prep(bt.g2T, bt.M, bt.pi)
    Sd = s_plane(bt.g1T, t2, v2, bt.pi, bt.mi, bt.n1, bt.n2)
    fa = fill_args(Sd, bt)
    fo = fill(*fa, bt.plan)
    ca = (bt.O1, bt.O2, bt.C1T, bt.C2T, bt.R1T, bt.R2T, bt.iv, bt.par, bt.Lm)
    sa = (bt.g1T, t2, v2, bt.pi, bt.mi, bt.n1, bt.n2)
    runs = {
        "s_prep": (lambda: s_prep(bt.g2T, bt.M, bt.pi),
                   lambda: s_prep_torch(bt.g2T, bt.M, bt.pi)),
        "s": (lambda: s_plane(*sa), lambda: s_plane_torch(*sa)),
        "fill": (lambda: fill(*fa, bt.plan), lambda: fill_torch(*fa)),
        "chase": (lambda: chase(fo, *ca), lambda: chase_torch(fo, *ca)),
    }
    out = {}
    for k, (kern, plain) in runs.items():
        a, b = kern(), plain()
        for name, x, y in zip(("out%d" % i for i in range(9)),
                              a if isinstance(a, tuple) else (a,),
                              b if isinstance(b, tuple) else (b,)):
            diff(k, x, y, name)
        out[k] = (time_cuda(plain, reps_plain), time_cuda(kern, reps_kernel),
                  time_cuda(plain, reps_plain), time_cuda(kern, reps_kernel))
    # K1's yardstick: one batched product and one matrix-vector product
    # compute t2 and v2 in another summation order; the port never calls it
    Mt = bt.M.transpose(1, 2).contiguous()
    lib = lambda: (torch.bmm(Mt, bt.g2T),
                   torch.bmm(bt.pi[:, None, :], bt.g2T))
    t2l, v2l = lib()
    lib_err = max(float((t2l - t2).abs().max()),
                  float((v2l[:, 0] - v2).abs().max()))
    library = {"s_prep": min(time_cuda(lib, reps_kernel),
                             time_cuda(lib, reps_kernel))}
    # K3 under every cluster size, and with the rings in global memory
    B, _, n1max = bt.g1T.shape
    cands = max(gdp._cands_per_cell(p) for p in preps)
    sweep = {}
    for C in cluster_sizes(dev):
        pl = plan_fill(B, n1max, bt.Rmax, cands, blocks_per_pair=C)
        sweep["C%d" % C] = time_cuda(lambda: fill(*fa, pl), reps_kernel)
    band = -(-n1max // bt.plan.blocks_per_pair)
    gl = bt.plan._replace(smem_rings=False, smem_bytes=2 * band * 4)
    sweep["global_rings"] = time_cuda(lambda: fill(*fa, gl), reps_kernel)
    packed = chase(fo, *ca).cpu().numpy()
    t0 = time.perf_counter()
    for g1, g2, m, sc in items:
        checks.native_align(g1, g2, m, sc)
    native_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    gdp.align_pairs_device(items, dev)
    batch_ms = (time.perf_counter() - t0) * 1e3
    return {"times": out, "bounds": bounds(preps, packed, bt.Lm),
            "library": library, "library_max_abs_diff": lib_err,
            "plan": bt.plan, "sweep": sweep, "native_ms": native_ms,
            "batch_ms": batch_ms}


def phase_times(dev, largest, root):
    t0 = time.perf_counter()
    rng = np.random.RandomState(3)
    m = checks.model(0.5)
    long_pairs = [(checks.chain(checks.random_seq(rng, 2000)),
                   checks.chain(checks.random_seq(rng, 1980)), m)
                  for _ in range(8)]
    long_items, _ = checks.items_and_expected(long_pairs)
    shapes = {"fam100_level": (largest, 20, 3),
              "8x2000x1980": (long_items, 5, 1),
              "fam500_root": (root, 5, 1)}
    res = {}
    for shape, (items, rk, rp) in shapes.items():
        r = res[shape] = kernel_times(items, dev, rk, rp)
        n1 = [it[0].size for it in items]
        n2 = [it[1].size for it in items]
        say("times:" + shape, t0, pairs=len(items),
            nodes="%d-%dx%d-%d" % (min(n1), max(n1), min(n2), max(n2)),
            native_align_node_ms="%.3f" % r["native_ms"],
            device_batch_wall_ms="%.3f" % r["batch_ms"],
            fill_plan=json.dumps(r["plan"]._asdict(), separators=(",", ":")),
            fill_sweep_ms=json.dumps({k: round(v, 4)
                                      for k, v in r["sweep"].items()},
                                     separators=(",", ":")),
            bound_ms=json.dumps({k: "%.5f/%s" % v
                                 for k, v in r["bounds"].items()},
                                separators=(",", ":")),
            s_prep_library_ms="%.4f" % r["library"]["s_prep"],
            s_prep_library_max_abs_diff="%.3g" % r["library_max_abs_diff"],
            **{k: "%.4f/%.4f/%.4f/%.4f" % v for k, v in r["times"].items()})
        t0 = time.perf_counter()
    return res


def main():
    name, smi = phase_device()
    dev = torch.device("cuda")
    phase_build()
    phase_s(dev)
    phase_fill_chase(dev)
    os.makedirs(OUT, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=OUT) as tmp:
        launches, largest = phase_fam100(dev, tmp)
        phase_walls(tmp)
        launches500, root = phase_levels(dev, tmp)
    res = phase_times(dev, largest, root)
    stray = [m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "prographmsa_tpu" or m.startswith("prographmsa_tpu.")]
    if stray:
        raise AssertionError("the port imported %s" % stray)
    with open(os.path.join(OUT, "chip_smoke_detail.txt"), "w") as f:
        f.write("\n".join(detail) + "\n")
    kern = []
    main_shape = "fam100_level"
    for k, (src, repl) in KERNELS.items():
        row = {"name": k, "route": "cuda", "source": src, "replaces": repl,
               "launches": launches[k], "launches_fam500": launches500[k],
               "max_abs_err": max_err[k]}
        for shape, r in res.items():
            p0, k0, p1, k1 = r["times"][k]
            sfx = "" if shape == main_shape else "_" + shape
            row["ms" + sfx] = min(k0, k1)
            row["plain_ms" + sfx] = min(p0, p1)
            row["bound_ms" + sfx], row["bound_by" + sfx] = r["bounds"][k]
            row["library_ms" + sfx] = r["library"].get(k)
            if k == "fill":
                row["blocks_per_pair" + sfx] = r["plan"].blocks_per_pair
        kern.append(row)
    print(json.dumps({"kernels": kern}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
