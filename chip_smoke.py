"""Smoke check of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from csrc/ with nvcc and its C++ host tier
with g++, holds each kernel against its plain PyTorch version and the host
oracles, drives the port's CLI main path (fam100 fixed tree and free tree,
fam500 one pass, fam500 with NW distances) against the goldens and the
port's own ``--engine native`` run on the same host, and times every kernel
beside its plain version, its roofline bound and, where one PyTorch call
computes the same function, that call.  Two paths are read for launches:
the fixed tree (the DP batch's kernels K1, K2, K3, X1) and the free tree
``c2_fam100`` (those and the distance kernels D2 ``nw``, D1
``pair_stats``), each with the counts set to 0 just before it.  Phase
``corpus`` runs every golden case of tests/test_e2e_differential.py (with
r_fam20 and --profile_out) through the port in process with every pair on
the card.  Phase ``reroot`` runs the root search (``-r``, ``-r -r``) and
``--early_refinement`` at fam100 and fam500, each in a process of its own
that reads its launches from zero (PORT_RUN), against ``--engine native``
byte for byte, with both walls, the DP batches' sizes, the launches of
K1, K2, K3, X1 and D1 and the device batch's phases (dp_prep, dp_device,
dp_harvest); on fam500 ``-r -i 0``'s largest batch it holds the native
slot tables and launch planes against the numpy bodies bit for bit, both
timed (with ``--parent``, the parent tree's run of it beside).  Phase
``walls`` also runs ``--engine auto`` (golden; the levels it sent to the
card) and ``--engine device`` (whether fam500 equals native, reported);
``rates`` prints the calibration and the rates engine_policy.py holds.
Phase ``threads`` runs fam500 ``-i 0`` on both tiers and ``-r -i 0`` on
the card tier at ``PROGRAPHMSA_THREADS=1`` beside ``walls``' and
``reroot``'s runs at the default pool, every output against its golden, with each wall and the
level's host stage (``merge``, ``extend``, ``clean``, ``dp_fused``: native
batches timed on the scheduler's thread).
Phase ``start`` holds ``walls``' fresh
processes of t_fam100 and fam500 ``-i 0`` against their goldens and prints
their walls, their import of torch (``card_start``) and fam500's wait for
its first guide tree, built in a process of its own (``tree_wait``).
Phase ``fam1000_default`` runs the CLI's default (``--fasta``, ``-i 2``)
on fam1000 as bench_torch.py makes it, in a process of its own, against
the JAX package's golden (prealigned_golden.py) byte for byte, with 8
launches of D1 (two re-trees of four blocks of pairs each), and the same
under ``--engine native --device cpu`` (the host tier's native pair
statistics) against the same golden; it prints the peak host RSS and
torch's peak card memory on a line of its own (with ``--parent``, the
parent tree's card run beside them).  Phase ``fam2000_default`` does the
same at 2,000 sequences (32 launches of D1) against its golden, with each
tier's ``distances``, ``nj``, ``tree_wait``, ``dp_device`` and
``dp_fused`` and the card tier's device batch counters (``fb_*``,
``pairs_*``, ``launches_wide``), and fails on any pair that leaves the
card (every one of its 5,997 is taken); it never runs the parent.
Phase ``wide_pair`` holds K1, K2 and K3 on a pair with a side of 5,800
nodes (either order; rings in global memory) against their plain
versions, and the whole batch against the host's ``align_graphs``.
Phases ``fill_kernel`` and ``chase_kernel`` include pairs of int64 code
words (141 offset slots and rings of 311 diagonals, either order; a
repeat slot of index 68 on the walk), and phase ``wide_slots`` a pair at
the largest wide shape of the 2,000 run (910 x 5,897 nodes, 50 x 156
slots, R 415): K3 and X1 against their plain versions, the batch against
the native host DP, both kernels timed (the kernels line's ``_wide``
keys).
Phase ``mesh`` (phase_mesh) holds the
scale-out on the one card: the split programs and the level and
root-search batches over 1, 2 and 4 shards of cuda:0 against the unsplit
work, c2_fam100 through the CLI over 4 shards (its launches are the
kernels line's ``launches_mesh``), S3's and S4's card time beside their
bounds, and three runs in two processes of one cluster sharing the card
against one process.  Phase ``resume`` (phase_resume) runs
``--checkpoint_dir``: c2_fam100 resumed as a process of its own (no
distances, no NJ), fam100 --mldist --nwdist stopped inside iteration 1 and
resumed in process with its launches read from zero (the kernels line's
``launches_resume``: D1 and the DP kernels, no D2), and fam500 -T -i 0
under two engines on one directory.  Every phase raises on failure; there
is no CPU fallback.  One line per phase, then one JSON line of kernels, the
card's name and power limit, and last {"ok": true, "device": {...}}.  Long
output goes to the directory ``OUT`` below.

Two times per kernel.  ``ms`` is the call time: CUDA events round a loop
of calls of the Python wrapper, so a kernel shorter than its launch path
reads as that path.  ``device_ms`` is the kernel's own time on the card:
the same calls captured once in a CUDA graph and replayed between two
events, free of Python.  ``launch_floor_ms`` is an empty grid timed the
same way, what any launch costs there.

The bound of a kernel is the larger of its bytes (each input read once,
each output written once, the pairs' own cells only) over HBM_BYTES_S and
its operations over F32_INSTR_S: the H100 SXM's published peaks, the float32
one halved because it counts a fused multiply-add as two and the kernels'
products and sums are separate roundings, one instruction each (K2's count
per cell is S_CELL_OPS, term by term).  ``bound_old_ms`` is the bound as it
was reckoned before (F32_FLOPS, 12 operations per cell of K2).  K2 writes
more than the bound counts, the whole padded array [B, D, n1max] with NEG
outside the pairs' cells; that write stands beside the bound and not in it:
``write_floor_ms`` is the array's bytes over HBM_BYTES_S and
``fill_device_ms`` one ``fill_`` of an array of that size, measured.  The
chase is a chain of dependent reads that no roofline shows, so it has a
second bound, ``chain_ms``: the longest walk's steps times one dependent
read from shared memory (``chain_l2_ms``: from L2), both latencies measured
on the card by pgm_chase_latency.  D2's operations are NW_CELL_OPS a cell
at the rates each issues at: int32 at INT32_OPS_S, its DPX maxima at the
rates pgm_dpx_rate measures in this run (nw_bound); ``bound_old_ms`` is
its bound before DPX (NW_CELL_OPS_OLD int32 operations a cell).  D1's
operations (pair_stats_bound) are PAIR_WORD_OPS a 32-column word of a pair,
PAIR_COUNT_OPS a counted column (the counts' sum) and PAIR_PACK_OPS a
column of a packed row, population counts and bit scans at BITS_OPS_S;
its bytes count the counts at their width; ``bound_old_ms`` is its first
form's reckoning (int32 counts, PAIR_COL_OPS_OLD a pair-column).

    python3 chip_smoke.py --parent DIR

also times the D1 of the tree checked out at DIR (pair_stats_time.py, in a
process of its own) before and after this tree's, on the same alignments,
and runs phase fam1000_default on that tree before and after this one's
(phase fam2000_default runs this tree only).
"""

from __future__ import annotations

import argparse
import contextlib
import gzip
import io
import json
import os
import platform
import re
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

import bench_torch
from prographmsa_tpu_torch import _build, checks, engine_policy, native, timings
from prographmsa_tpu_torch import cli as port_cli
from prographmsa_tpu_torch.align import graph_dp_cuda as gdp
from prographmsa_tpu_torch.align import scores_cuda
from prographmsa_tpu_torch.align.chase_cuda import (MAX_WINDOW, N_STATS,
                                                    chase, chase_torch,
                                                    plan_chase, row_width)
from prographmsa_tpu_torch.align.fill_cuda import (card_limits, code_dtype,
                                                   fill, fill_torch, plan_fill)
from prographmsa_tpu_torch.align.slots import COST_INF
from prographmsa_tpu_torch.align.scores_cuda import (
    DGROUPS, S_SMEM_MAX, S_THREADS, XVECS, exact_s, plan_s,
    plan_s_prep, s_plane, s_plane_torch, s_prep, s_prep_torch, s_smem_bytes,
    unshear)
from prographmsa_tpu_torch.alphabet import AA_SPEC
from prographmsa_tpu_torch.cs_profile import CSProfileLibrary
from prographmsa_tpu_torch.device import full_float32
from prographmsa_tpu_torch.distances.align import (GAP_PARAMS, _load_scoring,
                                                   _seq_codes)
from prographmsa_tpu_torch.distances.angle import kmer_counts
from prographmsa_tpu_torch.distances.nw_cuda import nw_counts, nw_torch, plan_nw
from prographmsa_tpu_torch.distances.prealigned import (
    CARD_BLOCK_PAIRS, _pair_stats_batch_host, _pair_stats_batch_numpy,
    host_block_pairs)
from prographmsa_tpu_torch.distances.prealigned_cuda import (
    count_dtype, pair_pack, pair_pack_torch, pair_stats, pair_stats_torch,
    words)
from prographmsa_tpu_torch.engine import level_driver
from prographmsa_tpu_torch.io.fasta import read_fasta
from prographmsa_tpu_torch.parallel import dryrun as port_dryrun
from prographmsa_tpu_torch.parallel.mesh import Mesh, split
from prographmsa_tpu_torch.parallel.sharded import (sharded_freq_hist,
                                                    sharded_gram,
                                                    sharded_nw_counts)

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
    "nw": ("prographmsa_tpu_torch/csrc/nw.cu",
           "prographmsa_tpu/distances/nw_device.py:38"),
    "pair_pack": ("prographmsa_tpu_torch/csrc/pair_stats.cu",
                  "prographmsa_tpu/distances/prealigned_device.py:98"),
    "pair_stats": ("prographmsa_tpu_torch/csrc/pair_stats.cu",
                   "prographmsa_tpu/distances/prealigned_device.py:45"),
}
DP_KERNELS = ("s_prep", "s", "fill", "chase")    # the graph-pair DP batch
DIST_KERNELS = ("nw", "pair_pack", "pair_stats")  # the guide-tree distances
max_err = {k: 0.0 for k in KERNELS}
detail = []
CALL_REPS = 200               # calls per call-time reading of K1
HBM_BYTES_S = 3.35e12          # H100 SXM device memory rate
F32_FLOPS = 67e12              # H100 SXM float32 outside the tensor cores,
                               # a fused multiply-add counted as two
F32_INSTR_S = F32_FLOPS / 2    # the same lanes issuing one operation each:
                               # the kernels' products and sums are separate
                               # roundings, none is fused
INT32_OPS_S = F32_INSTR_S / 2  # an H100 SM has 64 int32 lanes beside its 128
                               # float32 lanes (NVIDIA's Hopper white paper)
BITS_OPS_S = INT32_OPS_S / 4   # population count, bit reverse, find leading
                               # one: 16 a clock an SM (the CUDA C++
                               # programming guide's throughput table, 9.0)
# A correctly rounded float32 division: the reciprocal, a Newton step on it
# (2), the quotient, two residual corrections (2 each).
DIV_OPS = 8
# K2's operations per cell beyond the 2 * dim of num, term by term.
S_CELL_OPS = {"den = v1 * v2": 1, "num / den": DIV_OPS,
              "NaN to the x86 NaN: compare, select": 2,
              "ef: shift, subtract, convert": 3, "dm: and, xor": 2,
              "dm - lsC": 1, "lsB / (dm - lsC)": DIV_OPS,
              "body: three sums": 3, "tail: three sums": 3,
              "body or tail: position, compare, select": 3,
              "NaN or < NEG to NEG: two compares, select": 3}
# D2's fewest instructions a cell, by the rate each issues at: two sums,
# three DPX maxima (X and Y one __viaddmax_s32 each, W the max of three),
# the backtrack bits (both packed by one instruction at best).
NW_CELL_OPS = {"int32": {"diagonal: sum": 1, "W + go: sum": 1,
                         "backtrack bits: one insert": 1},
               "viaddmax": {"X: sum and max": 1, "Y: sum and max": 1},
               "vibmax": {"W: max of three": 1}}
# The count D2's bound took before DPX, int32 operations a cell (X, Y: two
# sums and a max each; the diagonal's sum; W: two max; two compares for the
# bits): bound_old_ms.
NW_CELL_OPS_OLD = 11
# D1's fewest operations, by the rate each issues at: per 32-column word
# of a pair (the gap scan of both sides and the counted columns' word), per
# counted column (the bit walk into the histogram) and per column of a row
# the pack turns into bit planes.
PAIR_WORD_OPS = {"int32": {"T, X, Y: and, two and-nots": 3, "Ki & Kj": 1,
                           "a, per side: shift, or-and": 4,
                           "E, per side: sum, or-and-not": 4,
                           "openings, per side: shift, and-not-or, sum": 6,
                           "carry out, per side: shift": 2},
                 "bits": {"openings, per side: population count": 2}}
PAIR_COUNT_OPS = {"int32": {"clear the bit: sum, and": 2, "column: sum": 1,
                            "histogram index: multiply-add": 1,
                            "histogram: add": 1},
                  "bits": {"find the bit: reverse, find leading one": 2}}
PAIR_PACK_OPS = {"int32": {"gapped: compare, or beyond L": 2,
                           "counted: unsigned compare, and": 2,
                           "value or 0: select": 1, "two ballots": 2},
                 "bits": {}}
# The count D1's bound took in its first form, int32 operations per pair
# and column (bound_old_ms, the counts in int32).
PAIR_COL_OPS_OLD = 16


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
        a, b = a.long(), b.long()
        ok = torch.equal(a, b)
        err = (a - b).abs().double()
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


def s_prep_layouts(B, dim, n2max):
    """The launch's own plan of K1 (None) and every layout it is compiled
    for that these sizes allow."""
    return [None] + [plan_s_prep(B, dim, n2max, dgroup=g, xvec=v)
                     for g in DGROUPS for v in XVECS
                     if v == 1 or n2max % 4 == 0]


def s_prep_check(g2T, M, pi):
    """K1 under each layout against s_prep_torch, bit for bit; returns the
    output under the launch's own plan and the layouts checked."""
    t2p, v2p = s_prep_torch(g2T, M, pi)
    layouts = s_prep_layouts(*g2T.shape)
    for plan in reversed(layouts):
        t2, v2 = s_prep(g2T, M, pi, plan)
        diff("s_prep", t2, t2p, "t2 under %s" % (plan,))
        diff("s_prep", v2, v2p, "v2 under %s" % (plan,))
    return t2, v2, len(layouts)


def s_layouts(B, dim, n1max, n2max):
    """The launch's own plan of K2 (None) and every layout it is compiled
    for that these sizes allow: each block size under tiles of one diagonal,
    of 7 (no whole groups of the diagonals a thread runs at a time), of 32
    and of more diagonals than the plane has."""
    D = n1max + n2max - 1
    return [None] + [plan_s(B, dim, n1max, n2max, threads=t, dtile=d)
                     for t in S_THREADS for d in (1, 7, 32, D + 5)
                     if s_smem_bytes(dim, t, d) <= S_SMEM_MAX]


def s_plane_check(g1T, t2, v2, pi, mi, n1, n2):
    """K2 under each layout against s_plane_torch on the whole array, bit
    for bit; returns the output under the launch's own plan and the layouts
    checked."""
    args = (g1T, t2, v2, pi, mi, n1, n2)
    want = s_plane_torch(*args)
    layouts = s_layouts(g1T.shape[0], g1T.shape[1], g1T.shape[2],
                        t2.shape[2])
    for plan in reversed(layouts):
        Sd = s_plane(*args, plan=plan)
        diff("s", Sd, want, "Sdiag under %s" % (plan,))
    return Sd, len(layouts)


def s_check(bt):
    """K1 and K2 (every layout of each) against their plain versions, and
    the two launched from one call, with and without programmatic dependent
    launch, against K2 alone."""
    t2, v2, _ = s_prep_check(bt.g2T, bt.M, bt.pi)
    Sd, _ = s_plane_check(bt.g1T, t2, v2, bt.pi, bt.mi, bt.n1, bt.n2)
    for pdl in (False, True):
        diff("s", exact_s_with(pdl, bt), Sd, "Sdiag of exact_s, pdl=%s" % pdl)
    return Sd


# (n1max, n2max, n1 per pair, n2 per pair) K2 is held against its plain
# version on at every width: a 3 x 2 pair beside long ones with sides that
# are no multiples of 4; n1 << n2 and n1 >> n2 with sides that are (tiles
# wholly below, above and across the band); a plane smaller than one tile.
S_SHAPES = ((203, 317, (203, 3, 150), (317, 2, 20)),
            (64, 520, (64, 10), (520, 519)),
            (520, 36, (520, 300), (36, 5)),
            (37, 50, (37, 21), (50, 50)))


def s_inputs(rng, dim, n1max, n2max, n1, n2, dev):
    """Random inputs of K2 with all-zero first rows of g1 and t2 (0/0, the
    NaN quotient of the sentinel nodes)."""
    B = len(n1)
    t = lambda *shape: rng.rand(*shape).astype(np.float32)
    g1T, t2, v2 = t(B, dim, n1max), t(B, dim, n2max), t(B, n2max) + 0.1
    g1T[:, :, 0] = t2[:, :, 0] = v2[:, 0] = 0.0
    arrs = (g1T, t2, v2, t(B, dim), t(B), np.array(n1, np.int32),
            np.array(n2, np.int32))
    return tuple(torch.from_numpy(a).to(dev) for a in arrs)


def exact_s_with(pdl, bt):
    """exact_s with K2 launched as K1's programmatic dependent or not."""
    return exact_s(bt.g1T, bt.g2T, bt.M, bt.pi, bt.mi, bt.n1, bt.n2, pdl=pdl)


def chase_args(bt, R1T=None, R2T=None):
    return (bt.O1, bt.O2, bt.C1T, bt.C2T, bt.R1T if R1T is None else R1T,
            bt.R2T if R2T is None else R2T, bt.iv, bt.par, bt.Lm)


def chase_layouts(bt):
    """The launch's own plan of X1 and other block sizes and code windows,
    down to a window of 2 cells a side that nearly every step leaves."""
    B, _, n1max = bt.g1T.shape
    opmax, n2max = bt.O1.shape[1], bt.g2T.shape[2]
    return [plan_chase(B, opmax, n1max, n2max)] + [
        plan_chase(B, opmax, n1max, n2max, win=w, threads=t)
        for w, t in ((2, 32), (8, 64), (16, 128), (32, 256),
                     (MAX_WINDOW, 32))]


def chase_check(fo, bt, name, model=True, **flags):
    """X1 under each layout against chase_torch, whole rows; with ``model``
    also the kernel's counts (steps, window fills, boundary replays)
    against the numpy model of its walk.  Returns (layouts checked, the
    counts under the launch's own plan)."""
    ca = chase_args(bt, **flags)
    want = chase_torch(fo, *ca)
    B = want.shape[0]
    layouts = chase_layouts(bt)
    first = None
    cpu = lambda ts: [t.cpu() for t in ts]
    for plan in layouts:
        stats = torch.full((B, N_STATS), -1, dtype=torch.int32,
                           device=want.device)
        diff("chase", chase(fo, *ca, plan=plan, stats=stats), want,
             "%s under %s" % (name, plan))
        stats = stats.cpu().numpy()
        if model:
            _, ms = checks.chase_window_model(
                type(fo)(*cpu(fo)), *cpu(ca[:-1]), bt.Lm, win=plan.win)
            if not np.array_equal(stats, ms):
                raise AssertionError("chase %s under %s: counts %s, model %s"
                                     % (name, plan, stats.tolist(),
                                        ms.tolist()))
        first = stats if first is None else first
    diff("chase", chase(fo, *ca), want, name + " without counts")
    return len(layouts), first


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


def kernel_sass(pattern, out_name):
    """The SASS of the kernel whose mangled name matches ``pattern``, from
    the built library, also written to chiprun_out/<out_name>."""
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", _build.so_path()],
                          capture_output=True, text=True, timeout=300).stdout
    os.makedirs(OUT, exist_ok=True)
    for block in sass.split("Function : "):
        if re.search(pattern, block.split("\n")[0]):
            with open(os.path.join(OUT, out_name), "w") as f:
                f.write(block)
            return block
    raise AssertionError("no kernel %s in %s" % (pattern, _build.so_path()))


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
    # K1 alone at the alphabets' widths (DNA 4, protein 20, codons 61, the
    # widest it takes), every layout
    n_layouts = 0
    for dim in (4, 20, 61, scores_cuda.MAX_DIM):
        for B, n2max in ((1, 203), (5, 316)):
            g2T, M, pi = (torch.from_numpy(rng.rand(*shape).astype(
                np.float32)).to(dev) for shape in (
                    (B, dim, n2max), (B, dim, dim), (B, dim)))
            n_layouts += s_prep_check(g2T, M, pi)[2]
    # K2 alone at those widths and at one that is not compiled in, every
    # layout, on the shapes of S_SHAPES
    n_s_layouts = 0
    for dim in (4, 20, 23, 61, scores_cuda.MAX_DIM):
        for shape in S_SHAPES:
            n_s_layouts += s_plane_check(*s_inputs(rng, dim, *shape, dev))[1]
    # the second division of K2 without the range test, on every mantissa
    bad = torch.zeros(1, dtype=torch.int32, device=dev)
    _build.launch((), _build.lib().pgm_q_check, *scores_cuda._LS[1:],
                  _build.ptr(bad))
    if int(bad) != 0:
        raise AssertionError("div_normal differs from __fdiv_rn on %d of "
                             "2^23 mantissas" % int(bad))
    say("s_kernel", t0, pairs=len(pairs) + 1, cells=n_cells,
        vs_host="bit-identical", vs_plain="bit-identical",
        s_prep_layouts_checked_dim_4_20_61_64=n_layouts,
        s_layouts_checked_dim_4_20_23_61_64=n_s_layouts,
        div_normal_vs_fdiv_rn_2p23_mantissas="bit-identical")


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


def wide_fill_pairs():
    """Pairs of int64 code words: a heavy graph of 141 offset slots with a
    skip of 300 (rings of 300 + 9 + 2 = 311 diagonals) against a heavy
    graph of 5 slots, in both orders; and a repeat pair whose walk steps
    through a repeat slot of index 68 (checks.wide_repeat_pair)."""
    m = checks.model(0.5)
    big = checks.heavy(420, list(range(2, 141)) + [300], 23, p_edge=0.1)
    small = checks.heavy(200, [2, 3, 5, 9], 24)
    return [(big, small, m), (small, big, m)], [checks.wide_repeat_pair()]


def phase_fill_chase(dev):
    pairs, reps, single = fill_pairs()
    wide, wide_reps = wide_fill_pairs()
    groups = ((pairs, checks.OPTS), (reps, checks.REPEAT_OPTS),
              (single, checks.OPTS), (wide, checks.OPTS),
              (wide_reps, checks.REPEAT_OPTS))
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
    (_, _, bt_w, fo_w), (_, _, bt_r, fo_r) = outs[-2:]
    if (bt_w.O1.shape[1] <= 128 or bt_w.Rmax <= 256
            or code_dtype(bt_r.O1.shape[1]) != torch.int64
            or {fo_w.codes.dtype, fo_r.codes.dtype} != {torch.int64}):
        raise AssertionError("fill_chase: the wide pairs are not wide: %d "
                             "and %d slots, R %d"
                             % (bt_w.O1.shape[1], bt_r.O1.shape[1],
                                bt_w.Rmax))
    say("fill_kernel", t1, pairs=n_pairs, layouts_checked=n_layouts,
        codes_rings_stripes="bit-identical",
        wide_pairs=len(wide) + len(wide_reps),
        wide_slots="%d,%d" % (bt_w.O1.shape[1], bt_r.O1.shape[1]),
        wide_R=bt_w.Rmax, wide_codes="int64",
        wide_own_plan_rings="shared" if bt_w.plan.smem_rings else "global",
        wide_rings_checked="shared+global")

    t1 = time.perf_counter()
    n_layouts = n_over = 0
    for (_, opts), (items, expected, bt, fo) in zip(groups, outs):
        n_layouts += chase_check(fo, bt, "packed")[0]
        if opts is checks.REPEAT_OPTS:
            # every step a repeat step: more than EV_CAP events, fail_rep
            ones = torch.ones_like(bt.R1T), torch.ones_like(bt.R2T)
            chase_check(fo, bt, "event overflow", R1T=ones[0], R2T=ones[1])
            over = chase(fo, *chase_args(bt, *ones))[:, 2 * bt.Lm + 2]
            n_over += int(over.sum())
        res = gdp.align_pairs_device(items, dev)
        for k, (r, aln) in enumerate(zip(res, expected)):
            g1, g2, mm, sc = items[k]
            ref = checks.native_or_host(g1, g2, mm, sc, aln)
            if not checks.same_alignment(r, ref):
                raise AssertionError("pair %d: device alignment differs "
                                     "from the host" % k)
            n_rep += int(r[3] > 0)
    if n_rep == 0 or n_over == 0:
        raise AssertionError("no repeat event or no event overflow was "
                             "exercised")
    say("chase_kernel", t1, pairs=n_pairs, layouts_checked=n_layouts,
        pairs_with_repeat_events=n_rep, pairs_with_event_overflow=n_over,
        vs_plain="bit-identical rows", vs_model="equal counts",
        vs_native="mappings+score+n_tr identical",
        wide_repeat_slot=list(outs[-1][2].O1[0].tolist()).index(71))


def wide_pairs():
    """A merged-like pair with a side over 4,096 nodes, in both orders:
    heavy graphs (checks.heavy) of 5,800 and 900 nodes with offsets up to
    120 and 100, so the rings of 222 diagonals live in global memory
    (plan_fill's smem_rings False), as at the top of a 2,000-sequence tree
    (its largest pair, 865 x 5,767 nodes)."""
    m = checks.model(0.4)
    big = checks.heavy(5800, [2, 3, 5, 60, 120], 21)
    small = checks.heavy(900, [2, 4, 100], 22)
    return [(big, small, m), (small, big, m)]


def phase_wide_pair(dev):
    """K1, K2 and K3 on each wide pair against their plain versions on the
    same launch (K1 and K2 under every layout; K3 under the launch's own
    plan, that plan with the rings in global memory, and one block a
    pair), and the pair through the whole batch (X1 and the harvest)
    against the host's align_graphs: mappings, score bits and
    n_tr_indels.  The 5,800-row order's own plan keeps its rings in global
    memory."""
    from prographmsa_tpu_torch.engine.progressive import align_graphs
    t1 = time.perf_counter()
    shapes = []
    for g1, g2, m in wide_pairs():
        sc = checks.DynProgScores(g1, g2, m, checks.OPTS)
        items = [(g1, g2, m, sc)]
        _, bt = pack(items, dev)
        n1max = bt.g1T.shape[2]
        if n1max > 4096 and bt.plan.smem_rings:
            raise AssertionError("wide pair: plan %s for %d x %d nodes"
                                 % (bt.plan, g1.size, g2.size))
        Sd = s_check(bt)
        band = -(-n1max // bt.plan.blocks_per_pair)
        fill_check(Sd, bt, [bt.plan, bt.plan._replace(
            smem_rings=False, smem_bytes=2 * band * 4),
            plan_fill(1, n1max, bt.Rmax, blocks_per_pair=1)])
        res = gdp.align_pairs_device(items, dev)[0]
        host = align_graphs(g1, g2, m, checks.OPTS, sc)[0]
        if not checks.same_alignment(res, host):
            raise AssertionError("wide pair %d x %d: the batch differs from "
                                 "align_graphs" % (g1.size, g2.size))
        shapes.append("%dx%d" % (g1.size, g2.size))
    say("wide_pair", t1, pairs=",".join(shapes), rings="shared+global",
        vs_plain="K1,K2,K3 bit-identical",
        vs_host="mappings+score+n_tr identical")


# The census's pair of most rings at 2,000 sequences with every slot table
# wide (dp_refusals.py --n 2000): n1, n2, each side's slots and largest
# offset; R = 178 + 235 + 2 = 415.
CENSUS_PAIR = ((910, 50, 178), (5897, 156, 235))


def census_graph(n, slots, reach, seed, p_edge):
    """A heavy graph of ``n`` nodes with ``slots`` offset slots (the
    chain's 1 and ``slots - 1`` others up to ``reach``, ``reach`` among
    them), each node's extra edge at each offset with probability
    ``p_edge``: a mean in-degree of a few, like a merged graph's."""
    rng = np.random.RandomState(seed)
    offs = rng.choice(np.arange(2, reach), slots - 2, replace=False)
    return checks.heavy(n, sorted(offs.tolist()) + [reach], seed + 1,
                        p_edge=p_edge)


def phase_wide_slots(dev):
    """A pair at the census's largest wide shape (CENSUS_PAIR: 910 x 5,897
    nodes, 50 x 156 offset slots, R 415) through the batch against the
    native host DP (mappings, score bits, n_tr_indels), and its launch's
    K3 and X1 (int64 code words, the rings in global memory) against
    fill_torch and chase_torch bit for bit, the plain versions timed on
    that one call, the kernels in call time and device time.  Returns the
    kernels line's ``_wide`` numbers."""
    t1 = time.perf_counter()
    (n1, k1, o1), (n2, k2, o2) = CENSUS_PAIR
    m = checks.model(0.4)
    g1 = census_graph(n1, k1, o1, 41, 0.05)
    g2 = census_graph(n2, k2, o2, 43, 0.02)
    sc = checks.DynProgScores(g1, g2, m, checks.OPTS)
    items = [(g1, g2, m, sc)]
    preps, bt = pack(items, dev)
    p = preps[0]
    if (len(p.o1), len(p.o2), p.R, p.shb) != (k1, k2, o1 + o2 + 2, 8) or \
            bt.plan.smem_rings:
        raise AssertionError("census pair: %d x %d slots, R %d, shb %d, "
                             "plan %s" % (len(p.o1), len(p.o2), p.R, p.shb,
                                          bt.plan))
    Sd = exact_s(bt.g1T, bt.g2T, bt.M, bt.pi, bt.mi, bt.n1, bt.n2)
    fa = fill_args(Sd, bt)
    fo = fill(*fa, bt.plan)
    (fill_plain_ms,), fp = time_plain_once(lambda: fill_torch(*fa))
    for name, a, b in zip(fo._fields, fo, fp):
        diff("fill", a, b, "%s of the census pair" % name)
    del fp
    ca = chase_args(bt)
    stats = torch.zeros((1, N_STATS), dtype=torch.int32, device=dev)
    got = chase(fo, *ca, stats=stats)
    (chase_plain_ms,), want = time_plain_once(lambda: chase_torch(fo, *ca))
    diff("chase", got, want, "row of the census pair")
    res = gdp.align_pairs_device(items, dev)[0]
    nat = checks.native_align(*items[0])
    if not checks.same_alignment(res, nat):
        raise AssertionError("census pair: the batch differs from the "
                             "native host DP")
    reps = 3
    run_fill = lambda: fill(*fa, bt.plan)
    run_chase = lambda: chase(fo, *ca)
    steps = stats.cpu().numpy()[:, 0]
    bnd = bounds(preps, steps, bt.Lm)
    out = {}
    for k, fn, plain_ms in (("fill", run_fill, fill_plain_ms),
                            ("chase", run_chase, chase_plain_ms)):
        out[k] = {"ms": min(time_cuda(fn, reps) for _ in range(2)),
                  "device_ms": device_time(fn, reps),
                  "plain_ms": plain_ms, "bound_ms": bnd[k][0],
                  "bound_by": bnd[k][1]}
    out["chase"]["steps"] = int(steps[0])
    shape = "%dx%d_slots%dx%d_R%d" % (n1, n2, k1, k2, p.R)
    say("wide_slots", t1, pair=shape, codes=str(fo.codes.dtype),
        fill_plan=json.dumps(bt.plan._asdict(), separators=(",", ":")),
        vs_plain="K3,X1 bit-identical",
        vs_native="mappings+score+n_tr identical",
        **{"%s_%s" % (k, q): ("%.4f" % v if isinstance(v, float) else v)
           for k, r in out.items() for q, v in r.items()})
    return shape, out


def time_plain_once(plain):
    """(the call's ms, its result) of one call of a plain version."""
    res = []
    return (time_cuda(lambda: res.append(plain()), 1, warm=False),), res[0]


def run_port(argv, record=None):
    """Port CLI in-process; returns (stderr text, timings counters).
    ``record``: a list that receives every level batch's items."""
    orig = gdp.align_pairs_device
    if record is not None:
        def wrapped(items, device, mesh=None):
            record.append(list(items))
            return orig(items, device, mesh)
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
    if not all(launches[k] > 0 for k in DP_KERNELS):
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
    launches_c2 = dict(_build.LAUNCHES)
    # the free-tree path: NW (D2) for the first tree, the prealigned
    # statistics (D1) for each re-tree, the DP batch of every pass
    if launches_c2["nw"] < 1 or launches_c2["pair_stats"] < 1 or not all(
            launches_c2[k] > 0 for k in KERNELS):
        raise AssertionError("c2: a kernel was not launched: %s"
                             % launches_c2)
    say("fam100", t0, t_fam100="golden", c2_fam100="golden+stderr",
        pairs_per_pass=pairs_t, c2_pairs=ctr2["torch_pairs_total"],
        fb=0, launches=json.dumps(launches, separators=(",", ":")),
        launches_c2=json.dumps(launches_c2, separators=(",", ":")))
    return launches, launches_c2, max(levels, key=len)


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
    if not all(launches[k] > 0 for k in DP_KERNELS):
        raise AssertionError("fam500: a kernel was not launched: %s"
                             % launches)
    rows, total = [], {k: 0.0 for k in DP_KERNELS}
    total_dev = {k: 0.0 for k in DP_KERNELS}
    for lv, items in enumerate(levels):
        preps, bt = pack(items, dev)
        t2, v2 = s_prep(bt.g2T, bt.M, bt.pi)
        Sd = s_plane(bt.g1T, t2, v2, bt.pi, bt.mi, bt.n1, bt.n2)
        fo = fill(*fill_args(Sd, bt), bt.plan)
        runs = {
            "s_prep": lambda: s_prep(bt.g2T, bt.M, bt.pi),
            "s": lambda: s_plane(bt.g1T, t2, v2, bt.pi, bt.mi, bt.n1, bt.n2),
            "fill": lambda: fill(*fill_args(Sd, bt), bt.plan),
            "chase": lambda: chase(fo, *chase_args(bt))}
        ms = {k: time_cuda(fn, 3) for k, fn in runs.items()}
        dms = {k: device_time(fn, 3) for k, fn in runs.items()}
        for k in DP_KERNELS:
            total[k] += ms[k]
            total_dev[k] += dms[k]
        slots = max(len(p.o1) * len(p.o2) for p in preps)
        nmax = max(max(p.g1.size, p.g2.size) for p in preps)
        rows.append((lv, len(items), nmax, slots, max(p.R for p in preps),
                     bt.plan, ms, dms))
    note("== fam500 -i 0 levels: level pairs max_nodes max_slot_pairs "
         "max_R blocks_per_pair lanes threads smem_rings "
         "ms(s_prep s fill chase) device_ms(s_prep s fill chase)")
    note(*("%2d %4d %5d %5d %4d %d %2d %4d %d  %.4f %.4f %.4f %.4f  "
           "%.4f %.4f %.4f %.4f"
           % (lv, b, n, sl, r, pl.blocks_per_pair, pl.lanes, pl.threads,
              pl.smem_rings, *(ms[k] for k in DP_KERNELS),
              *(dms[k] for k in DP_KERNELS))
           for lv, b, n, sl, r, pl, ms, dms in rows))
    top = sorted(rows, key=lambda r: -r[6]["fill"])[:3]
    say("levels:fam500", t0, levels=len(rows),
        launches=json.dumps(launches, separators=(",", ":")),
        kernel_ms_sum=json.dumps({k: round(v, 4) for k, v in total.items()},
                                 separators=(",", ":")),
        kernel_device_ms_sum=json.dumps(
            {k: round(v, 4) for k, v in total_dev.items()},
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
    n_chase, _ = chase_check(fo, bt, "root packed", model=False)
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
        layouts_checked=n, chase_layouts_checked=n_chase,
        vs_plain="bit-identical (full pair)",
        vs_native="mappings+score+n_tr identical")
    return launches, root, total, total_dev, levels


def cli_wall(args, out, extra=(), env=None):
    cmd = [sys.executable, "-m", "prographmsa_tpu_torch.cli", *args, *extra,
           "-o", out]
    t0 = time.perf_counter()
    p = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                       timeout=900, env=env)
    wall = time.perf_counter() - t0
    if p.returncode != 0:
        raise AssertionError("%s exited %d: %s" % (cmd, p.returncode,
                                                   p.stderr[-3000:]))
    return wall, p.stderr


def timing_of(err, name):
    """Seconds of phase ``name`` in a --timings report (None if absent)."""
    m = re.search(r"^\s+%s\s+([0-9.]+) s" % re.escape(name), err, re.M)
    return float(m.group(1)) if m else None


def tree_phase(err, name):
    """Seconds of the guide trees' phase ``name``: those in the process,
    plus those of a first tree built apart (``name``_apart, first_tree.py)."""
    here, apart = timing_of(err, name), timing_of(err, name + "_apart")
    return here if apart is None else "%s+%s_apart" % (here or 0, apart)


def counters_of(err):
    return {ln.split()[0]: int(ln.split()[1]) for ln in
            err.split("counters:")[-1].strip().splitlines()}


WALLS = (("t_fam100", ["--fasta", "-t", GOLD + "/tree0_fam100.nwk",
                       FIX + "/fam100.fasta"]),
         ("fam500_i0", ["--fasta", "-i", "0", FIX + "/fam500.fasta"]),
         ("c2_fam100", ["--fasta", "--mldist", "--nwdist",
                        FIX + "/fam100.fasta"]),
         ("fam500_nwdist_i0", ["--fasta", "--nwdist", "-i", "0",
                               FIX + "/fam500.fasta"]))


def phase_walls(tmp, runs):
    """The port on the card against its own --engine native on this host,
    as separate processes, byte for byte: fam100 fixed tree, fam500 -i 0,
    fam100 free tree (--mldist --nwdist: NW and prealigned on the card) and
    fam500 --nwdist -i 0, with the distances' share from --timings; then
    --engine auto on the fixed tree (golden, and the levels it sent to the
    card), --engine device on fam500 -i 0 (reported, not held), and the
    start-up (imports, CUDA context) of each.  Each port run's wall,
    stderr and output go into ``runs`` (phase ``mesh`` reads them)."""
    t0 = time.perf_counter()
    if not native.available():
        raise AssertionError("the port's native host library did not build: "
                             "--engine native would time the numpy tier")
    walls = {}
    for name, args in WALLS:
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
        ctr = counters_of(err)
        check_counters(ctr, name)
        note("== %s port --timings" % name, err,
             "== %s native --timings" % name, err_nat)
        walls[name] = (w_port, w_nat)
        runs[name] = {"wall": w_port, "err": err, "out": o_port,
                      "ref": o_nat, "ref_wall": w_nat, "ref_err": err_nat}
        say(name, t0, port_s="%.3f" % w_port, native_s="%.3f" % w_nat,
            identical=True, pairs_device=ctr["torch_pairs_device"],
            pairs_total=ctr["torch_pairs_total"],
            distances_s="%s/%s" % (tree_phase(err, "distances"),
                                   timing_of(err_nat, "distances")),
            nj_s="%s/%s" % (tree_phase(err, "nj"), timing_of(err_nat, "nj")),
            **{k: ctr.get("torch_" + k, 0) for k in gdp.FALLBACK_KEYS
               if k.startswith("fb_")})
        t0 = time.perf_counter()
    # --engine auto: the calibrated gate per level
    o_auto = os.path.join(tmp, "t_fam100.auto")
    w_auto, err = cli_wall(WALLS[0][1], o_auto, ("--engine", "auto",
                                                 "--device", "cuda",
                                                 "--timings"))
    if not same_file(o_auto, GOLD + "/t_fam100.fasta"):
        raise AssertionError("t_fam100 under --engine auto differs from the "
                             "golden")
    ctr = counters_of(err)
    check_counters(ctr, "t_fam100 auto")
    note("== t_fam100 --engine auto --timings", err)
    say("auto:t_fam100", t0, port_s="%.3f" % w_auto, golden=True,
        levels_card=ctr.get("torch_levels_device", 0),
        levels_host=ctr.get("torch_levels_host", 0),
        pairs_card=ctr.get("torch_pairs_device", 0))
    # --engine device: the angle Gram in float32 on the card (NJ may break a
    # tie otherwise than the host's float64), reported as a fact
    t0 = time.perf_counter()
    o_dev = os.path.join(tmp, "fam500_i0.device")
    w_dev, err = cli_wall(WALLS[1][1], o_dev, ("--engine", "device",
                                               "--device", "cuda",
                                               "--timings"))
    note("== fam500 -i 0 --engine device --timings", err)
    say("device:fam500_i0", t0, port_s="%.3f" % w_dev,
        equals_native=same_file(o_dev, os.path.join(tmp,
                                                    "fam500_i0.native")),
        distances_s=timing_of(err, "distances"))
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


# phase ``threads``: (run of phase walls or reroot, its golden)
# (cell, golden, the tiers that run it at one thread too): fam500 -r -i 0
# at one thread on the host tier (48 s) left out to keep the script's time
THREADS = (("fam500_i0", "fam500_i0.fasta", ("card", "native")),
           ("r_fam500_i0", "fam500_r_i0.fasta", ("card",)))
HOST_STAGE = ("merge", "extend", "clean", "dp_fused")


def phase_threads(tmp, runs, smi):
    """The level's host stage at one thread beside the default pool:
    fam500 -i 0 on both tiers (card: --engine torch --device cuda; native:
    --engine native) and -r -i 0 on the card tier at PROGRAPHMSA_THREADS=1,
    each a CLI process, and the default pool's runs of phases walls and
    reroot on both tiers (their walls as those phases took them); every
    output held to its golden.
    Prints each wall and the phases merge, extend, clean and dp_fused
    (native batches timed on the scheduler's thread: wall time), with the
    card's name and power limit.  Fails on a wrong byte, never on a
    time."""
    t0 = time.perf_counter()
    args_of = dict(WALLS + REROOT)
    env1 = dict(os.environ, PROGRAPHMSA_THREADS="1")
    for name, golden, one_thread in THREADS:
        r = runs[name]
        for tier, extra, out, wall, err in (
                ("card", ("--engine", "torch", "--device", "cuda"), r["out"],
                 r["wall"], r["err"]),
                ("native", ("--engine", "native"), r["ref"], r["ref_wall"],
                 r["ref_err"])):
            got = [("default", out, wall, err)]
            if tier in one_thread:
                o1 = os.path.join(tmp, "%s.%s.t1" % (name, tier))
                w1, err1 = cli_wall(args_of[name], o1,
                                    extra + ("--timings",), env1)
                note("== %s %s PROGRAPHMSA_THREADS=1 --timings"
                     % (name, tier), err1)
                got.append(("1", o1, w1, err1))
            for threads, o, w, e in got:
                if not same_file(o, os.path.join(GOLD, golden)):
                    raise AssertionError("%s %s at %s threads differs from "
                                         "%s" % (name, tier, threads, golden))
                say("threads", t0, cell=name, tier=tier, threads=threads,
                    golden=True, wall_s="%.3f" % w,
                    **{k + "_s": timing_of(e, k) for k in HOST_STAGE})
                t0 = time.perf_counter()
    say("threads", t0, card=json.dumps(smi))


def phase_start(runs):
    """Process start in phase ``walls``' fresh processes of t_fam100 and
    fam500 -i 0: each output held to its golden, stderr up to the --timings
    report empty, and printed: the wall, the CLI's import of torch and
    resolution of the device (``card_start``) and, where the first guide
    tree was built in a process of its own beside it (first_tree.py;
    fam500 -i 0, not the fixed tree), the wait for that tree
    (``tree_wait``) and its ``distances``, apart or not."""
    t0 = time.perf_counter()
    got = {}
    for name, apart in (("t_fam100", False), ("fam500_i0", True)):
        run = runs[name]
        if not same_file(run["out"], os.path.join(GOLD, name + ".fasta")):
            raise AssertionError("%s differs from the golden" % name)
        err = run["err"]
        if err.split("timings (wall seconds")[0]:
            raise AssertionError("%s wrote to stderr:\n%s" % (name, err))
        start, wait = timing_of(err, "card_start"), timing_of(err,
                                                             "tree_wait")
        if start is None or (wait is not None) != apart:
            raise AssertionError("%s: card_start %s, tree_wait %s in its "
                                 "--timings report:\n%s"
                                 % (name, start, wait, err))
        got.update({name + "_wall_s": "%.3f" % run["wall"],
                    name + "_card_start_s": start,
                    name + "_tree_wait_s": wait,
                    name + "_distances_s": tree_phase(err, "distances")})
    say("start", t0, golden=True, **got)


class Interrupted(Exception):
    """Raised inside a run to stop it where an interruption would."""


# A CLI run in a process of its own, for the default-run phases: its
# launches, the peak RSS of its children (the first guide tree's process)
# and torch's peak card memory, into the JSON file argv[1]; the CLI's
# arguments follow.  torch is imported after the run, as the CLI imports
# it, so the first tree is built apart as in a user's run; a run that
# imported no torch (--engine native) reports no card memory.
MEMORY_RUN = """
import json, resource, sys
from prographmsa_tpu_torch import _build
from prographmsa_tpu_torch.cli import main
rc = main(sys.argv[2:])
rec = {"launches": dict(_build.LAUNCHES),
       "tree_rss_bytes": resource.getrusage(
           resource.RUSAGE_CHILDREN).ru_maxrss * 1024,
       "card_allocated_bytes": None, "card_reserved_bytes": None}
if "torch" in sys.modules:
    import torch
    rec["card_allocated_bytes"] = torch.cuda.max_memory_allocated()
    rec["card_reserved_bytes"] = torch.cuda.max_memory_reserved()
with open(sys.argv[1], "w") as f:
    json.dump(rec, f)
sys.exit(rc)
"""
FAM1000 = (1000, 300, 0)   # make_family(n, length, AA, seed), bench's fam1000
FAM1000_GOLDEN = GOLD + "/fam1000_seed0.fasta.gz"   # prealigned_golden.py
FAM2000 = (2000, 300, 0)
FAM2000_GOLDEN = GOLD + "/fam2000_seed0.fasta.gz"   # ... --n 2000
FAM1000_RETREES = 2        # the CLI's default -i 2
RSS_PERIOD_S = 0.02


def peak_rss(proc, deadline):
    """The largest resident set of the process ``proc`` (a Popen) read from
    /proc/PID/statm every RSS_PERIOD_S until it exits (None where that file
    cannot be read).  Its own getrusage would not do: ru_maxrss keeps,
    across exec, the peak of the process that spawned it (this script's,
    gigabytes once torch is in).  Kills it at ``deadline``."""
    page, peak = os.sysconf("SC_PAGE_SIZE"), None
    while proc.poll() is None:
        if time.perf_counter() > deadline:
            proc.kill()
            raise AssertionError("a default run outlasted its time "
                                 "limit")
        with contextlib.suppress(OSError, ValueError, IndexError):
            with open("/proc/%d/statm" % proc.pid) as f:
                peak = max(peak or 0, int(f.read().split()[1]) * page)
        time.sleep(RSS_PERIOD_S)
    return peak


def memory_run(tree, fasta, out, extra=(), limit_s=900):
    """The default CLI run of ``fasta`` (with the flags ``extra``) by the
    port at ``tree`` (this checkout or a parent's), through MEMORY_RUN,
    killed after ``limit_s``: (wall s, its record with the peak RSS
    sampled, stderr)."""
    rec = out + ".json"
    t1 = time.perf_counter()
    with open(out + ".stderr", "w+") as err:
        p = subprocess.Popen([sys.executable, "-c", MEMORY_RUN, rec,
                              "--fasta", fasta, *extra, "--timings", "-o",
                              out], cwd=tree, stdout=subprocess.DEVNULL,
                             stderr=err)
        rss = peak_rss(p, t1 + limit_s)
        wall = time.perf_counter() - t1
        err.seek(0)
        text = err.read()
    if p.returncode != 0:
        raise AssertionError("default run at %s exited %d: %s"
                             % (tree, p.returncode, text[-3000:]))
    with open(rec) as f:
        return wall, dict(json.load(f), host_rss_bytes=rss), text


def phase_default_run(tmp, label, n, gold_path, parent=None,
                      all_on_card=False):
    """The CLI's default run (``--fasta``: ``-i 2``, two re-trees from
    prealigned distances, D1 on the card) on ``make_family(n, 300, AA,
    0)`` as bench_torch.py makes fam1000, in a process of its own, against
    the JAX package's golden (prealigned_golden.py --n N) byte for byte:
    each re-tree's n (n - 1) / 2 pairs are calls of D1 of
    prealigned.CARD_BLOCK_PAIRS pairs each, one launch of ``pair_pack``
    and of ``pair_stats`` a call.  The same family under ``--engine native
    --device cpu`` too (the host tier: native pair statistics and BioNJ,
    no launch), held to the same golden.  Prints each tier's wall and its
    ``distances`` (of which ``ml_newton``), ``nj``, ``tree_wait``,
    ``dp_device`` and ``dp_fused`` phases, the card tier's ``torch_fb_*``
    counts, and on a line of its own
    the peak host RSS and torch's peak card memory.  With ``parent``, the
    tree at that path runs the card tier before and after this one (held
    to the golden too).  With ``all_on_card``, fails on any pair that left
    the card's batch.  Returns the card tier's counters."""
    t0 = time.perf_counter()
    _, length, seed = FAM1000
    fasta = os.path.join(tmp, "%s_seed%d.fasta" % (label, seed))
    mf = bench_torch.make_fixtures()
    mf.write_fasta(fasta, mf.make_family(n, length, bench_torch.AA, seed))
    with gzip.open(gold_path, "rb") as f:
        gold = f.read()
    native_tier = ("--engine", "native", "--device", "cpu")
    trees = [("parent_before", parent, ())] if parent else []
    trees += [("port", REPO, ()), ("native", REPO, native_tier)]
    trees += [("parent_after", parent, ())] if parent else []
    runs = {}
    for name, tree, extra in trees:
        out = os.path.join(tmp, "%s_%s.fasta" % (label, name))
        wall, rec, err = memory_run(tree, fasta, out, extra)
        note("== %s %s --timings" % (label, name), err)
        with open(out, "rb") as f:
            if f.read() != gold:
                raise AssertionError("%s (%s) differs from %s"
                                     % (label, name, gold_path))
        runs[name] = dict(rec, wall_s=wall, err=err)
    port = runs["port"]
    calls = FAM1000_RETREES * -(-(n * (n - 1) // 2) // CARD_BLOCK_PAIRS)
    got = {k: port["launches"].get(k) for k in DIST_KERNELS}
    if got != {"nw": 0, "pair_pack": calls, "pair_stats": calls} or not all(
            port["launches"][k] > 0 for k in DP_KERNELS):
        raise AssertionError("%s: launches %s, %d calls of D1 expected"
                             % (label, port["launches"], calls))
    nat = runs["native"]
    if any(nat["launches"].values()):
        raise AssertionError("%s: --engine native launched %s"
                             % (label, nat["launches"]))
    ctr = counters_of(port["err"])
    fb = {k: ctr.get("torch_" + k, 0)
          for k in gdp.FALLBACK_KEYS + gdp.WIDE_KEYS}
    if ctr.get("torch_fb_size", 0):
        raise AssertionError("%s: %d pairs past every launch (fb_size)"
                             % (label, ctr["torch_fb_size"]))
    if all_on_card:
        check_counters(ctr, label)
    gb = lambda b: "%.3f" % (b / 1e9) if b is not None else "none"
    phases = ("distances", "ml_newton", "nj", "tree_wait", "dp_device",
              "dp_fused")
    tier = lambda r, pre: {pre + k + "_s": tree_phase(r["err"], k)
                           for k in phases}
    say(label, t0, golden="identical", wall_s="%.3f" % port["wall_s"],
        **tier(port, ""), native_wall_s="%.3f" % nat["wall_s"],
        **tier(nat, "native_"),
        launches=json.dumps(port["launches"], separators=(",", ":")),
        **fb)
    print("%s memory: " % label + " ".join(
        "%s_host_rss_gb=%s %s_tree_rss_gb=%s %s_card_allocated_gb=%s "
        "%s_card_reserved_gb=%s %s_wall_s=%.3f" % (
            k, gb(r["host_rss_bytes"]), k, gb(r["tree_rss_bytes"]), k,
            gb(r["card_allocated_bytes"]), k, gb(r["card_reserved_bytes"]),
            k, r["wall_s"]) for k, r in runs.items()), flush=True)
    return ctr


def phase_fam1000_default(tmp, parent=None):
    """phase_default_run at 1,000 sequences: 8 launches of D1 (two re-trees
    of four blocks of pairs)."""
    return phase_default_run(tmp, "fam1000_default", FAM1000[0],
                             FAM1000_GOLDEN, parent)


def phase_fam2000_default(tmp):
    """phase_default_run at 2,000 sequences, HomFam's next size: 32
    launches of D1 (two re-trees of 16 blocks), every pair on the card
    (the top of the tree's pairs pass 4,096 nodes a side), BioNJ over the
    native library's threads.  Run without a parent tree."""
    return phase_default_run(tmp, "fam2000_default", FAM2000[0],
                             FAM2000_GOLDEN, all_on_card=True)


def interrupted_run(argv, at_pass):
    """The port's do_align on ``argv`` (the CLI's flags), stopped by
    Interrupted on its ``at_pass``-th progressive pass."""
    orig = level_driver.progressive_alignment_batched
    passes = [0]

    def stopping(*a, **kw):
        passes[0] += 1
        if passes[0] == at_pass:
            raise Interrupted
        return orig(*a, **kw)

    args = port_cli.build_parser().parse_args(argv)
    opts = port_cli.options_from_args(args).replace(engine="native")
    seqs, _ = read_fasta(opts.sequence_file)
    level_driver.progressive_alignment_batched = stopping
    try:
        port_cli.do_align(seqs, opts, torch.device(args.device), args.engine)
    except Interrupted:
        return
    finally:
        level_driver.progressive_alignment_batched = orig
    raise AssertionError("%s was not interrupted" % argv)


def phase_resume(tmp, runs, smi):
    """--checkpoint_dir on the card.  (a) c2_fam100 as a process of its
    own with a checkpoint directory, then again on it: both golden, stdout
    and stderr; the second with no ``distances`` and no ``nj`` in its
    --timings and its final pass on the card.  (b) fam100 --mldist
    --nwdist in process, stopped on its second progressive pass (inside
    iteration 1), then run again on its directory with the launch counts
    from 0 (the resumed path's ``launches_resume``): golden, the DP
    kernels and D1 launched, D2 not (the first tree came from the state).
    (c) fam500 -T -i 0 under --engine device and then --engine torch on one
    directory, each against its own fresh run on the card; whether the two
    engines' trees differ is printed."""
    t0 = time.perf_counter()
    ck = os.path.join(tmp, "ck_c2_fam100")
    walls, errs = {}, {}
    for run in ("first", "resumed"):
        out = os.path.join(tmp, "c2_fam100.resume_" + run)
        walls[run], err = cli_wall(WALLS[2][1], out, (
            "--engine", "torch", "--device", "cuda", "--timings",
            "--checkpoint_dir", ck))
        errs[run] = err
        note("== c2_fam100 --checkpoint_dir, %s run --timings" % run, err)
        if not same_file(out, GOLD + "/c2_fam100.fasta"):
            raise AssertionError("resume: c2_fam100's %s run differs from "
                                 "the golden" % run)
        with open(GOLD + "/c2_fam100.stderr") as f:
            if before_timings(err) != f.read():
                raise AssertionError("resume: c2_fam100's %s run: stderr "
                                     "differs from the golden" % run)
        ctr = counters_of(err)
        check_counters(ctr, "c2_fam100 %s run" % run)
        if not ctr.get("torch_pairs_device"):
            raise AssertionError("resume: c2_fam100's %s run put no pair on "
                                 "the card" % run)
    skipped = [k for k in ("distances", "nj")
               if timing_of(errs["resumed"], k) is not None]
    if skipped:
        raise AssertionError("resume: the resumed c2_fam100 ran %s"
                             % skipped)
    say("resume:c2_fam100", t0, golden="stdout+stderr", first_s="%.3f"
        % walls["first"], resumed_s="%.3f" % walls["resumed"],
        walls_c2_fam100_s="%.3f" % runs["c2_fam100"]["wall"],
        first_distances_s=timing_of(errs["first"], "distances"),
        first_nj_s=timing_of(errs["first"], "nj"),
        resumed_pairs_device=counters_of(errs["resumed"])[
            "torch_pairs_device"], card=repr(smi))

    t0 = time.perf_counter()
    ck = os.path.join(tmp, "ck_fam100")
    argv = ["--fasta", "--mldist", "--nwdist", FIX + "/fam100.fasta",
            "--engine", "torch", "--device", "cuda", "--timings",
            "--checkpoint_dir", ck]
    t1 = time.perf_counter()
    interrupted_run(argv, 2)
    w_stop = time.perf_counter() - t1
    out = os.path.join(tmp, "fam100.resumed")
    t1 = time.perf_counter()
    _build.reset_launches()
    err, ctr = run_port(argv + ["-o", out])
    launches = dict(_build.LAUNCHES)
    w_resumed = time.perf_counter() - t1
    note("== fam100 --mldist --nwdist resumed in iteration 1 --timings", err)
    if not same_file(out, GOLD + "/c2_fam100.fasta"):
        raise AssertionError("resume: the interrupted fam100 run, resumed, "
                             "differs from the golden")
    check_counters(ctr, "fam100 resumed")
    if launches["nw"] or not all(launches[k] > 0 for k in
                                 DP_KERNELS + ("pair_pack", "pair_stats")):
        raise AssertionError("resume: the resumed run launched %s (D2 "
                             "none, every other kernel)" % launches)
    say("resume:fam100", t0, golden=True, stopped_s="%.3f" % w_stop,
        resumed_s="%.3f" % w_resumed,
        launches=json.dumps(launches, separators=(",", ":")),
        card=repr(smi))

    t0 = time.perf_counter()
    ck = os.path.join(tmp, "ck_fam500")
    trees, walls = {}, {}
    for engine in ("device", "torch"):
        for ckpt in ((), ("--checkpoint_dir", ck)):
            name = "fam500_T_%s%s" % (engine, "_ck" if ckpt else "")
            out = os.path.join(tmp, name)
            t1 = time.perf_counter()
            run_port(["-T", "-i", "0", FIX + "/fam500.fasta", "--engine",
                      engine, "--device", "cuda", "-o", out, *ckpt])
            walls[name] = "%.3f" % (time.perf_counter() - t1)
            with open(out) as f:
                trees[name] = f.read()
        if trees["fam500_T_%s_ck" % engine] != trees["fam500_T_" + engine]:
            raise AssertionError("resume: fam500 -T -i 0 under --engine %s "
                                 "on the directory differs from its fresh "
                                 "run" % engine)
    say("resume:engines", t0, each_its_own_fresh_tree=True,
        device_tree_differs_from_torch=trees["fam500_T_device"]
        != trees["fam500_T_torch"], walls_s=json.dumps(walls),
        card=repr(smi))
    return launches


def before_timings(err):
    """stderr without the --timings report at its end."""
    return err.split("timings (wall seconds")[0]


def phase_corpus(tmp):
    """Every golden case of tests/test_e2e_differential.py, r_fam20 and
    --profile_out through the port in process on the card, byte for byte,
    stderr too where a golden holds it; every pair on the card (cases with
    -T run no DP)."""
    t0 = time.perf_counter()
    sys.path.insert(0, os.path.join(REPO, "tests"))
    try:
        from test_e2e_differential import CASES, _strip_header
    finally:
        sys.path.pop(0)
    cases = list(CASES) + [("r_fam20.fasta", ["--fasta", "-r",
                                              FIX + "/fam20.fasta"])]
    bad, pairs = [], 0
    for golden, args in cases:
        out = os.path.join(tmp, "corpus_" + golden)
        err, ctr = run_port(args + ["--engine", "torch", "--device", "cuda",
                                    "--timings", "-o", out])
        with open(out) as f, open(os.path.join(GOLD, golden)) as g:
            if _strip_header(f.read()) != _strip_header(g.read()):
                bad.append("%s: output differs from the golden" % golden)
        err_gold = os.path.join(GOLD, os.path.splitext(golden)[0]
                                + ".stderr")
        if os.path.exists(err_gold):
            with open(err_gold) as f:
                if before_timings(err) != f.read():
                    bad.append("%s: stderr differs from the golden"
                               % golden)
        if "-T" in args:
            continue
        pairs += ctr.get("torch_pairs_total", 0)
        fb = {k: v for k, v in ctr.items() if k.startswith("torch_fb_") and v}
        left = ctr.get("torch_pairs_total", 0) - ctr.get("torch_pairs_device",
                                                         0)
        if fb or left or not ctr.get("torch_pairs_total"):
            bad.append("%s: %d pairs left the card, fallbacks %s"
                       % (golden, left, fb))
    out = os.path.join(tmp, "corpus_prof.fasta")
    prof = os.path.join(tmp, "corpus.profile")
    run_port(["--fasta", "--profile_out", prof, "-t", GOLD + "/tree0_fam20.nwk",
              FIX + "/fam20.fasta", "--device", "cuda", "-o", out])
    if not same_file(prof, GOLD + "/t_fam20.profile"):
        bad.append("t_fam20.profile: --profile_out differs from the golden")
    for line in bad:
        print("corpus: " + line, flush=True)
    if bad:
        raise AssertionError("corpus: %d of %d cases failed"
                             % (len(bad), len(cases) + 1))
    say("corpus", t0, cases=len(cases) + 1, identical=True, pairs=pairs,
        fb=0, seconds="%.2f" % (time.perf_counter() - t0))


# The port's CLI in a process of its own that also writes, to argv[1], the
# kernels' launch counts, the pairs of every call of the DP batch and the
# time (epoch seconds) at which the CLI returned; with SMOKE_MESH=1 in its
# environment, after that, also what mesh_batches finds on its largest
# batch.
PORT_RUN = """
import json, os, sys, time
from prographmsa_tpu_torch import _build
from prographmsa_tpu_torch.align import graph_dp_cuda as gdp
from prographmsa_tpu_torch.cli import main
sizes, largest, orig = [], [], gdp.align_pairs_device
keep = os.environ.get("SMOKE_MESH") == "1"
def recorded(items, device, mesh=None):
    sizes.append(len(items))
    if keep and len(items) > len(largest):
        largest[:] = items
    return orig(items, device, mesh)
gdp.align_pairs_device = recorded
rc = main(sys.argv[2:])
gdp.align_pairs_device = orig
run = {"launches": dict(_build.LAUNCHES), "batches": sizes,
       "t_main": time.time()}
if keep and rc == 0:
    import torch
    import dp_prep_time
    from chip_smoke import mesh_batches, shard_meshes
    dev = torch.device("cuda", 0)
    run["mesh"] = {"pairs": len(largest), "dp_device_s": mesh_batches(
        [largest], dev, shard_meshes(dev), turns=1)}
    run["prep"] = dict(dp_prep_time.compare([largest]), pairs=len(largest))
with open(sys.argv[1], "w") as f:
    json.dump(run, f)
sys.exit(rc)
"""

REROOT = (("r_t_fam100", ["--fasta", "-r", "-t", GOLD + "/tree0_fam100.nwk",
                          FIX + "/fam100.fasta"]),
          ("r_fam100", ["--fasta", "-r", FIX + "/fam100.fasta"]),
          ("er_t_fam100", ["--fasta", "--early_refinement", "-t",
                           GOLD + "/tree0_fam100.nwk",
                           FIX + "/fam100.fasta"]),
          ("r_fam500_i0", ["--fasta", "-r", "-i", "0",
                           FIX + "/fam500.fasta"]),
          ("rr_fam500_i0", ["--fasta", "-r", "-r", "-i", "0",
                            FIX + "/fam500.fasta"]),
          ("er_fam500_i0", ["--fasta", "--early_refinement", "-i", "0",
                            FIX + "/fam500.fasta"]))
REROOT_KERNELS = DP_KERNELS + ("pair_pack", "pair_stats")


def phase_reroot(tmp, runs, parent=None):
    """The root search and the early refinement at fam100 and fam500: the
    port on the card (a process of its own that records its DP batches and
    launches) against its own --engine native, byte for byte, stdout and
    stderr (the best score and TR lines; the --timings report apart), the
    two walls side by side (the port's from its start to its CLI's return)
    and the device batch's phases dp_prep, dp_device and dp_harvest.
    fam500 -r -i 0 also holds its largest batch over 1, 2 and 4 shards of
    the card against the unsplit batch (mesh_batches) after its CLI
    returns, and that batch's preparation and launch planes built by the
    native library against the numpy bodies, bit for bit, both timed
    (dp_prep_time.compare: host arrays, no copy to the card); with
    ``parent``, the tree at that path runs fam500 -r -i 0 on the card
    too, held to this tree's output, its dp phases printed beside.  Phase
    ``mesh`` reads ``runs``: each run's wall, stderr and output."""
    t0 = time.perf_counter()
    launches_of = {}
    for name, args in REROOT:
        o_port = os.path.join(tmp, name + ".port")
        o_nat = os.path.join(tmp, name + ".native")
        rec = os.path.join(tmp, name + ".json")
        cmd = [sys.executable, "-c", PORT_RUN, rec, *args, "--engine",
               "torch", "--device", "cuda", "--timings", "-o", o_port]
        t1 = time.time()
        p = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                           timeout=900,
                           env=dict(os.environ, SMOKE_MESH=str(
                               int(name == "r_fam500_i0"))))
        if p.returncode != 0:
            raise AssertionError("%s exited %d: %s" % (name, p.returncode,
                                                       p.stderr[-3000:]))
        err = p.stderr
        w_nat, err_nat = cli_wall(args, o_nat, ("--engine", "native",
                                                "--timings"))
        note("== %s port --timings" % name, err,
             "== %s native --timings" % name, err_nat)
        if not same_file(o_port, o_nat):
            raise AssertionError("%s: port differs from --engine native"
                                 % name)
        if before_timings(err) != before_timings(err_nat):
            raise AssertionError("%s: stderr differs from --engine native:"
                                 "\n%s\n%s" % (name, before_timings(err),
                                                before_timings(err_nat)))
        with open(rec) as f:
            run = json.load(f)
        w_port = run["t_main"] - t1
        runs[name] = {"wall": w_port, "err": err, "out": o_port,
                      "ref": o_nat, "mesh": run.get("mesh"),
                      "ref_wall": w_nat, "ref_err": err_nat}
        launches = {k: run["launches"][k] for k in REROOT_KERNELS}
        launches_of[name] = launches
        sizes = run["batches"]
        ctr = counters_of(err)
        fb = {k: ctr.get("torch_" + k, 0) for k in gdp.FALLBACK_KEYS
              if k.startswith("fb_")}
        if not all(launches[k] > 0 for k in DP_KERNELS):
            raise AssertionError("%s: a DP kernel was not launched: %s"
                                 % (name, launches))
        if name == "r_fam100" and not launches["pair_stats"]:
            raise AssertionError("r_fam100: D1 was not launched on the "
                                 "re-trees: %s" % launches)
        if (ctr["torch_pairs_device"] != ctr["torch_pairs_total"]
                or any(fb.values())):
            raise AssertionError("%s: pairs left the card: %s"
                                 % (name, ctr))
        score = [ln for ln in err.splitlines()
                 if ln.startswith("best gap parsimony score")]
        say(name, t0, port_s="%.3f" % w_port, native_s="%.3f" % w_nat,
            identical="stdout+stderr", score=score[0].split(": ")[1]
            if score else None, batches=len(sizes),
            batches_on_card=ctr.get("torch_levels_device", 0),
            pairs_max=max(sizes), pairs_mean="%.1f" % (sum(sizes)
                                                       / len(sizes)),
            pairs_device=ctr["torch_pairs_device"],
            pairs_total=ctr["torch_pairs_total"],
            launches=json.dumps(launches, separators=(",", ":")),
            dp_prep_s=timing_of(err, "dp_prep"),
            dp_device_s=timing_of(err, "dp_device"),
            dp_harvest_s=timing_of(err, "dp_harvest"),
            merge_s="%s/%s" % (timing_of(err, "merge"),
                               timing_of(err_nat, "merge")),
            **fb, **{k: ctr.get("torch_" + k, 0) for k in gdp.WIDE_KEYS})
        if "prep" in run:
            prep_check(run["prep"], t0)
        if parent and name == "r_fam500_i0":
            parent_reroot(parent, name, args, o_port, t0)
        t0 = time.perf_counter()
    return launches_of


def prep_check(res, t0):
    """Phase reroot's check of the native batch preparation on fam500 -r
    -i 0's largest batch (dp_prep_time.compare): bit for bit with the
    numpy bodies, both bodies' seconds of prep and pack."""
    if not res["identical"]:
        raise AssertionError("r_fam500_i0: the native batch preparation "
                             "differs from the numpy bodies")
    say("r_fam500_i0_prep", t0, pairs=res["pairs"],
        launches=res["launches"], identical="prep+pack",
        **{"%s_%s" % (b, k): "%.4f" % res[b][k][0]
           for b in ("native", "numpy") for k in ("prep_s", "pack_s")})


def parent_reroot(parent, name, args, o_port, t0):
    """``name`` run by the port at ``parent`` on the card, its output held
    to this tree's, its dp phases printed.  The parent's kernels and
    native library are built first, in a process of their own, so that
    no build falls into the run's phases."""
    subprocess.run([sys.executable, "-c", "from prographmsa_tpu_torch "
                    "import _build, native; _build.lib(); native.lib()"],
                   cwd=parent, check=True, capture_output=True, timeout=900)
    out = os.path.join(os.path.dirname(o_port), name + ".parent")
    p = subprocess.run([sys.executable, "-m", "prographmsa_tpu_torch.cli",
                        *args, "--engine", "torch", "--device", "cuda",
                        "--timings", "-o", out], cwd=parent,
                       capture_output=True, text=True, timeout=900)
    if p.returncode != 0:
        raise AssertionError("%s at %s exited %d: %s" % (
            name, parent, p.returncode, p.stderr[-3000:]))
    note("== %s parent --timings" % name, p.stderr)
    if not same_file(out, o_port):
        raise AssertionError("%s: the parent's output differs" % name)
    say(name + "_parent", t0, identical="output", **{
        k + "_s": timing_of(p.stderr, k)
        for k in ("dp_prep", "dp_device", "dp_harvest")})


MESH_SHARDS = (1, 2, 4)       # shards of one card phase ``mesh`` holds
# The runs phase ``mesh`` repeats in two processes of one cluster on the
# card, each against the single process of phase ``walls`` or ``reroot``.
TWO_PROCESS = (("fam500_nwdist_i0", WALLS[3][1]), ("c2_fam100", WALLS[2][1]),
               ("r_t_fam100", REROOT[0][1]))
JOIN = "prographmsa: joined distributed cluster as process"


def same_results(a, b):
    """Two results of align_pairs_device agree pair for pair: mappings,
    the score's bits and n_tr_indels, or both None (a host fallback)."""
    return len(a) == len(b) and all(
        (x is None and y is None) or (
            x is not None and y is not None and list(x[0]) == list(y[0])
            and list(x[1]) == list(y[1])
            and np.float32(x[2]).view(np.int32)
            == np.float32(y[2]).view(np.int32) and x[3] == y[3])
        for x, y in zip(a, b))


def shard_meshes(dev):
    """{name: mesh}: unsplit (None), then MESH_SHARDS shards of ``dev``."""
    meshes = {"unsplit": None}
    meshes.update({"%d_shards" % k: Mesh((dev,) * k) for k in MESH_SHARDS})
    return meshes


def mesh_batches(batches, dev, meshes, turns):
    """Every batch through align_pairs_device on ``dev`` under each of
    ``meshes`` (the first: the reference), in turns (twice: there and
    back), each held against the first's results; the least ``dp_device``
    seconds of each, summed over the batches."""
    order = list(meshes) + (list(meshes)[::-1] if turns == 2 else [])
    secs, ref = {k: [] for k in meshes}, None
    for name in order:
        timings.enable(True)
        res = [gdp.align_pairs_device(items, dev, meshes[name])
               for items in batches]
        buf = io.StringIO()
        timings.report(buf)
        timings.enable(False)
        secs[name].append(timing_of(buf.getvalue(), "dp_device"))
        if ref is None:
            ref = res
        elif not all(same_results(a, b) for a, b in zip(ref, res)):
            raise AssertionError("mesh: %s differs from the unsplit batch"
                                 % name)
    return {k: min(v) for k, v in secs.items()}


def host_ms(fn):
    """(fn's result, its milliseconds on the host's clock, the card
    synchronised before and after): a split program's wall, its copies
    and gathers included."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t0)


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def processes(name, args, tmp, n=2, env_of=lambda r: {}):
    """The port's CLI on the card in ``n`` processes of one cluster
    (PROGRAPHMSA_DIST=1, gloo on localhost), process r with ``env_of(r)``
    in its environment too: (wall, [(output path, stderr)])."""
    port = free_port()
    procs, outs = [], []
    t0 = time.perf_counter()
    for r in range(n):
        out = os.path.join(tmp, "%s.dist%d" % (name, r))
        env = dict(os.environ, PROGRAPHMSA_DIST="1",
                   PROGRAPHMSA_COORD="127.0.0.1:%d" % port,
                   PROGRAPHMSA_NUM_PROCESSES=str(n),
                   PROGRAPHMSA_PROCESS_ID=str(r), **env_of(r))
        procs.append((out, subprocess.Popen(
            [sys.executable, "-m", "prographmsa_tpu_torch.cli", *args,
             "--engine", "torch", "--device", "cuda", "--timings", "-o",
             out], cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)))
    try:
        for out, p in procs:
            stdout, err = p.communicate(timeout=600)
            if p.returncode != 0 or stdout:
                raise AssertionError("%s: a process of %d exited %d:\n%s"
                                     % (name, n, p.returncode, err[-3000:]))
            outs.append((out, err))
    finally:
        for _, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return time.perf_counter() - t0, outs


def check_processes(name, outs, one):
    """Each process's output equals one process's (``one``: its "out",
    "ref" (native's or the golden) and "err"), its stderr less the one join
    line and the --timings report too, and its counters."""
    want_err = before_timings(one["err"])
    for r, (o, err) in enumerate(outs):
        lines = err.splitlines(True)
        kept = [ln for ln in lines if not ln.startswith(JOIN)]
        if len(lines) - len(kept) != 1:
            raise AssertionError("%s: process %d printed %d join lines"
                                 % (name, r, len(lines) - len(kept)))
        if before_timings("".join(kept)) != want_err:
            raise AssertionError("%s: process %d's stderr differs from "
                                 "one process's" % (name, r))
        if not (same_file(o, one["out"]) and same_file(o, one["ref"])):
            raise AssertionError("%s: process %d's output differs from "
                                 "one process's or native's" % (name, r))
        if counters_of(err) != counters_of(one["err"]):
            raise AssertionError("%s: process %d's counters %s differ "
                                 "from one process's" %
                                 (name, r, counters_of(err)))


def phase_mesh(tmp, levels, runs, smi):
    """Scale-out on the one card.  In process, a mesh of 4 shards of cuda:0:
    S1 on fam100's and fam500's all pairs bit for bit against D2 unsplit;
    S3 (fam500's k-mer Gram) and S4 (fam500's +F histogram) against their
    plain results; fam500 -i 0's 16 level batches (mesh_batches, and the
    largest batch of fam500 -r -i 0 in phase reroot) over 1, 2 and 4 shards
    against the unsplit batch, with the dp_device seconds of each split;
    the dry run (parallel/dryrun.py); c2_fam100 through the CLI with its
    level mesh set to the 4 shards, golden stdout and stderr, the counts
    of launches from 0 (``launches_mesh``).  Then each of TWO_PROCESS in
    two processes of one cluster sharing the card: each process's output
    and stderr (less the join line) those of the single process and of
    native or the golden, its counters the single process's."""
    t0 = time.perf_counter()
    cuda0 = torch.device("cuda", 0)
    mesh4 = Mesh((cuda0,) * 4)
    aa = _load_scoring("aa")
    go, ge = GAP_PARAMS["aa"]
    s1_pairs, wall_ms = {}, {}
    t = lambda a: torch.from_numpy(a).to(cuda0)
    for name in ("fam100", "fam500"):
        cm, lens = fasta_codes(FIX + "/%s.fasta" % name)
        arrs = all_pairs(cm, lens)
        (counts, gaps), ms = host_ms(
            lambda: sharded_nw_counts(mesh4, *arrs, aa, go, ge, 20))
        (c0, g0), ms0 = host_ms(lambda: [
            x.cpu().numpy() for x in nw_counts(*map(t, arrs), t(aa), go, ge,
                                               20)])
        if not (np.array_equal(counts, c0) and np.array_equal(gaps, g0)):
            raise AssertionError("mesh: S1 on %s's pairs differs from D2 "
                                 "unsplit" % name)
        s1_pairs[name] = len(gaps)
        wall_ms["s1_" + name] = (ms, ms0)
    seqs, _ = read_fasta(FIX + "/fam500.fasta")
    enc = {n: AA_SPEC.encode(q) for n, q in seqs.items()}
    kc, _ = kmer_counts(AA_SPEC, enc, sorted(enc), AA_SPEC.kmer_k)
    kc = kc.astype(np.float32)
    full_float32()
    gram, ms = host_ms(lambda: sharded_gram(mesh4, kc))
    gram0, ms0 = host_ms(lambda: (lambda C: torch.matmul(C, C.T))(
        t(kc)).cpu().numpy())
    if not np.array_equal(gram, gram0):
        raise AssertionError("mesh: S3 differs from one float32 product")
    wall_ms["s3"] = (ms, ms0)
    # the card's share of S3: the 4 shards' products, and the one product
    W = t(kc)
    rows = [torch.as_tensor(i, device=cuda0) for i in split(len(kc), 4)]
    s_dev = {"s3_device_ms": device_time(
        lambda: [torch.matmul(W[i], W.T) for i in rows], 20),
        "s3_unsplit_device_ms": device_time(lambda: torch.matmul(W, W.T),
                                            20)}
    # an N x K by K x N product: N * N * K fused multiply-adds, two
    # operations each at F32_FLOPS; the counts read once, the Gram written
    s_dev["s3_bound_ms"], s_dev["s3_bound_by"] = bound_of_rates(
        kc.nbytes + 4 * len(kc) ** 2,
        2 * len(kc) ** 2 * kc.shape[1] / F32_FLOPS)
    vals = [AA_SPEC.values(q) for q in enc.values()]
    V = np.full((len(vals), max(map(len, vals))), -1, np.int32)
    for i, v in enumerate(vals):
        V[i, :len(v)] = v
    want, ms0 = host_ms(lambda: np.bincount(V[(V >= 0) & (V < 20)],
                                            minlength=20))
    hist, ms = host_ms(lambda: sharded_freq_hist(mesh4, V, 20))
    if not np.array_equal(hist, want):
        raise AssertionError("mesh: S4 differs from numpy's count")
    wall_ms["s4"] = (ms, ms0)
    # the card's share of S4: each shard's mask and count.  The mask's
    # gather syncs with the host, so no graph captures it: CUDA events
    # round a loop of the 4 shards' operations
    Vd = [t(np.ascontiguousarray(V[i])) for i in split(len(V), 4)]
    s_dev["s4_ms"] = time_cuda(lambda: [torch.bincount(
        r[(r >= 0) & (r < 20)].long(), minlength=20) for r in Vd], 20)
    # two compares a value, one count a valid one, at the int32 rate
    s_dev["s4_bound_ms"], s_dev["s4_bound_by"] = bound_of_rates(
        V.nbytes + 20 * 8,
        (2 * V.size + int(((V >= 0) & (V < 20)).sum())) / INT32_OPS_S)
    secs = mesh_batches(levels, cuda0, shard_meshes(cuda0), turns=2)
    big = runs["r_fam500_i0"]["mesh"]
    port_dryrun.dryrun(mesh4)
    say("mesh:card", t0, shards=4, s1_pairs=json.dumps(s1_pairs),
        s1="bit-identical", s3="identical", s4="identical",
        wall_ms_split_unsplit=json.dumps(
            {k: "%.3f/%.3f" % v for k, v in wall_ms.items()},
            separators=(",", ":")),
        levels_fam500=len(levels), dryrun="OK",
        dp_device_s_levels_fam500=json.dumps(secs, separators=(",", ":")),
        root_search_batch_pairs=big["pairs"],
        dp_device_s_root_search_batch=json.dumps(big["dp_device_s"],
                                                 separators=(",", ":")),
        s3_s4=json.dumps(s_dev, separators=(",", ":")), card=repr(smi))

    t0 = time.perf_counter()
    out = os.path.join(tmp, "c2_mesh.fasta")
    orig = engine_policy.level_mesh
    engine_policy.level_mesh = lambda device: mesh4
    _build.reset_launches()
    try:
        err, ctr = run_port(["--fasta", "--mldist", "--nwdist",
                             FIX + "/fam100.fasta", "--engine", "torch",
                             "--device", "cuda", "--timings", "-o", out])
    finally:
        engine_policy.level_mesh = orig
    launches = dict(_build.LAUNCHES)
    if not same_file(out, GOLD + "/c2_fam100.fasta"):
        raise AssertionError("c2_fam100 over the mesh differs from the "
                             "golden")
    with open(GOLD + "/c2_fam100.stderr") as f:
        if before_timings(err) != f.read():
            raise AssertionError("c2_fam100 over the mesh: stderr differs "
                                 "from the golden")
    check_counters(ctr, "c2_fam100 over the mesh")
    if ctr != counters_of(runs["c2_fam100"]["err"]):
        raise AssertionError("c2_fam100 over the mesh: counters %s differ "
                             "from one shard's" % ctr)
    if not all(launches[k] > 0 for k in DP_KERNELS + ("nw",)):
        raise AssertionError("c2_fam100 over the mesh: a kernel was not "
                             "launched: %s" % launches)
    say("mesh:c2_fam100", t0, shards=4, golden="stdout+stderr",
        launches_mesh=json.dumps(launches, separators=(",", ":")))

    for name, args in TWO_PROCESS:
        t0 = time.perf_counter()
        one = runs[name]
        wall, outs = processes(name, args, tmp)
        check_processes(name, outs, one)
        note("== %s, process 0 of 2 --timings" % name, outs[0][1])
        say("mesh:2proc", t0, run=name, identical="stdout+stderr+counters",
            wall_2proc_s="%.3f" % wall, wall_1proc_s="%.3f" % one["wall"],
            dp_device_s="%s/%s" % (timing_of(outs[0][1], "dp_device"),
                                   timing_of(one["err"], "dp_device")),
            distances_s="%s/%s" % (timing_of(outs[0][1], "distances"),
                                   timing_of(one["err"], "distances")),
            card=repr(smi))
    return launches


def time_cuda(fn, reps, warm=True):
    if warm:
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


def time_plain(plain, reps):
    """(two call times in ms, the result) of a kernel's plain version.  Its
    first call, whose result the kernel is held against, is the first
    reading; a plain version of a tenth of a second or more (K3's and X1's
    are Python loops over diagonals and steps, seconds long) is then timed
    without another warm-up call."""
    res = []
    first = time_cuda(lambda: res.append(plain()), 1, warm=False)
    return (first, time_cuda(plain, reps, warm=first < 100.0)), res[0]


def device_time(fn, reps):
    """Milliseconds of device time per call of ``fn``: ``reps`` calls
    captured once in a CUDA graph (the wrappers launch on the current
    stream, which under capture is the capture stream) and the graph
    replayed between two events, so no Python runs inside the timed span."""
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


def card_floors(dev):
    """What no kernel on this card goes below, in milliseconds: an empty
    grid's launch (device time), and one dependent read from shared memory
    and from L2 (one thread following a cyclic permutation, the time per
    read taken from two walk lengths)."""
    L = _build.lib()
    floor = device_time(lambda: _build.launch((), L.pgm_empty), 50)
    rng = np.random.RandomState(5)
    sink = torch.zeros(1, dtype=torch.int32, device=dev)
    read = {}
    for where, n in (("shared", 4096), ("l2", 1 << 20)):
        order = rng.permutation(n)
        nxt = np.empty(n, np.int32)
        nxt[order] = np.roll(order, -1)
        perm = torch.from_numpy(nxt).to(dev)
        t = [min(time_cuda(lambda: _build.launch(
            (), L.pgm_chase_latency, _build.ptr(perm), n, steps,
            int(where == "shared"), _build.ptr(sink)), 2) for _ in range(2))
            for steps in (20000, 220000)]
        read[where] = (t[1] - t[0]) / 200000
    return {"launch_floor_ms": floor, "shared_read_ms": read["shared"],
            "l2_read_ms": read["l2"]}


def bounds(preps, steps, Lm):
    """Per kernel (bound_ms, bound_by, old bound_ms) on these pairs: the
    larger of bytes over the memory rate and operations over the rate the
    card issues them at, from the pairs' own sizes; the chase counts the
    steps its walks took.  No counted operation is a fused multiply-add, so
    the rate is F32_INSTR_S.  The old bound took F32_FLOPS and 12
    operations for a cell of K2 beyond num."""
    by = {k: 0.0 for k in DP_KERNELS}
    op = {k: 0.0 for k in DP_KERNELS}
    op_s_old = 0.0
    s_cell = sum(S_CELL_OPS.values())
    for k, p in enumerate(preps):
        n1, n2, dim = p.g1.size, p.g2.size, p.g1.dim
        e1 = int(np.count_nonzero(p.C1 < COST_INF))
        e2 = int(np.count_nonzero(p.C2 < COST_INF))
        nl1, nl2 = len(p.o1), len(p.o2)
        by["s_prep"] += 4 * (dim * n2 + dim * dim + dim + dim * n2 + n2)
        op["s_prep"] += 2 * n2 * dim * dim + 2 * n2 * dim
        by["s"] += 4 * (dim * n1 + dim * n2 + n2 + dim + 1 + n1 * n2)
        # num per cell, the packet dot v1 per row, the rest per cell
        op["s"] += 2 * dim * n1 * n2 + (2 * dim + 3) * n1 + s_cell * n1 * n2
        op_s_old += 2 * dim * n1 * n2 + 2 * dim * n1 + 12 * n1 * n2
        # S in, codes out, slot tables in, four rings and two stripes out
        # the code word: 4 bytes, 8 past 64 slots (int64)
        cw = code_dtype(gdp.slots_of(p)).itemsize
        by["fill"] += 4 * (n1 * n2 + nl1 * n1 + nl2 * n2 + nl1 + nl2
                           + 4 * p.R * n1 + n1 + n2) + cw * n1 * n2
        # 3 per match candidate, 7 per edge of a Y or X move, 12 per cell
        op["fill"] += 3 * e1 * e2 + 7 * (e1 * n2 + e2 * n1) + 12 * n1 * n2
        # a step reads a code word and writes two mapping entries; the end
        # transition reads one cell of each of three rings per slot pair,
        # and each slot's offset and end cost
        by["chase"] += 4 * (row_width(Lm) + 2 * int(steps[k])
                            + 3 * nl1 * nl2 + 2 * (nl1 + nl2)) \
            + cw * int(steps[k])
        op["chase"] += 12 * nl1 * nl2 + 10 * int(steps[k])
    out = {}
    for k in DP_KERNELS:
        tb, to = by[k] / HBM_BYTES_S * 1e3, op[k] / F32_INSTR_S * 1e3
        old = max(tb, (op_s_old if k == "s" else op[k]) / F32_FLOPS * 1e3)
        out[k] = (max(tb, to), "bytes" if tb >= to else "operations", old)
    return out


def kernel_times(items, dev, reps_kernel, reps_plain, floors):
    preps, bt = pack(items, dev)
    t2, v2 = s_prep(bt.g2T, bt.M, bt.pi)
    Sd = s_plane(bt.g1T, t2, v2, bt.pi, bt.mi, bt.n1, bt.n2)
    fa = fill_args(Sd, bt)
    fo = fill(*fa, bt.plan)
    ca = chase_args(bt)
    sa = (bt.g1T, t2, v2, bt.pi, bt.mi, bt.n1, bt.n2)
    runs = {
        "s_prep": (lambda: s_prep(bt.g2T, bt.M, bt.pi),
                   lambda: s_prep_torch(bt.g2T, bt.M, bt.pi)),
        "s": (lambda: s_plane(*sa), lambda: s_plane_torch(*sa)),
        "fill": (lambda: fill(*fa, bt.plan), lambda: fill_torch(*fa)),
        "chase": (lambda: chase(fo, *ca), lambda: chase_torch(fo, *ca)),
    }
    out, dev_ms = {}, {}
    for k, (kern, plain) in runs.items():
        (p0, p1), b = time_plain(plain, reps_plain)
        a = kern()
        for name, x, y in zip(("out%d" % i for i in range(9)),
                              a if isinstance(a, tuple) else (a,),
                              b if isinstance(b, tuple) else (b,)):
            diff(k, x, y, name)
        out[k] = (p0, time_cuda(kern, reps_kernel),
                  p1, time_cuda(kern, reps_kernel))
        dev_ms[k] = min(device_time(kern, reps_kernel),
                        device_time(kern, reps_kernel))
    # K2's write: the whole padded array, NEG outside the pairs' cells.  It
    # stands beside the bound, which counts the cells only
    pad = torch.empty_like(Sd)
    s_write = {"write_floor_ms": pad.numel() * 4 / HBM_BYTES_S * 1e3,
               "fill_device_ms": min(device_time(lambda: pad.fill_(-1.0),
                                                 reps_kernel)
                                     for _ in range(2))}
    del pad
    # K1's yardstick: one batched product and one matrix-vector product
    # compute t2 and v2 in another summation order; the port never calls it
    Mt = bt.M.transpose(1, 2).contiguous()
    lib = lambda: (torch.bmm(Mt, bt.g2T),
                   torch.bmm(bt.pi[:, None, :], bt.g2T))
    t2l, v2l = lib()
    lib_err = max(float((t2l - t2).abs().max()),
                  float((v2l[:, 0] - v2).abs().max()))
    # call times of two calls this short are the host's launch path: many
    # repetitions, K1 and the library call in turns
    turns = [(time_cuda(runs["s_prep"][0], CALL_REPS),
              time_cuda(lib, CALL_REPS)) for _ in range(3)]
    k1_call = min(t[0] for t in turns)
    out["s_prep"] = (out["s_prep"][0], k1_call, out["s_prep"][2], k1_call)
    library = {"s_prep": min(t[1] for t in turns)}
    library_dev = {"s_prep": min(device_time(lib, reps_kernel),
                                 device_time(lib, reps_kernel))}
    # K1 + K2 as the main path launches them: one call, with and without
    # programmatic dependent launch, beside the two wrappers in turn
    two = lambda: s_plane(bt.g1T, *s_prep(bt.g2T, bt.M, bt.pi), bt.pi, bt.mi,
                          bt.n1, bt.n2)
    exact = {}
    reps_s = CALL_REPS if dev_ms["s"] < 0.1 else reps_kernel
    for name, fn in (("two_wrappers", two),
                     ("one_call", lambda: exact_s_with(False, bt)),
                     ("one_call_pdl", lambda: exact_s_with(True, bt))):
        exact[name] = (min(time_cuda(fn, reps_s) for _ in range(2)),
                       min(device_time(fn, reps_kernel) for _ in range(2)))
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
    # X1 under other code windows and block sizes (device time), and what
    # its walks did under the launch's own plan
    opmax, n2max = bt.O1.shape[1], bt.g2T.shape[2]
    own = plan_chase(B, opmax, n1max, n2max)
    chase_sweep = {}
    for win, threads in ((8, own.threads), (16, own.threads),
                         (MAX_WINDOW, own.threads), (own.win, 32),
                         (own.win, 256)):
        pl = plan_chase(B, opmax, n1max, n2max, win=win, threads=threads)
        chase_sweep["w%d_t%d" % (win, threads)] = device_time(
            lambda: chase(fo, *ca, plan=pl), reps_kernel)
    stats = torch.zeros((B, N_STATS), dtype=torch.int32, device=dev)
    chase(fo, *ca, stats=stats)
    stats = stats.cpu().numpy()
    steps = int(stats[:, 0].max())
    walks = {"plan": "w%d_t%d" % (own.win, own.threads),
             "longest_steps": steps, "steps": int(stats[:, 0].sum()),
             "window_fills": int(stats[:, 1].sum()),
             "boundary_replays": int(stats[:, 2].sum())}
    chain = {"chain_ms": steps * floors["shared_read_ms"],
             "chain_l2_ms": steps * floors["l2_read_ms"]}
    t0 = time.perf_counter()
    for g1, g2, m, sc in items:
        checks.native_align(g1, g2, m, sc)
    native_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    gdp.align_pairs_device(items, dev)
    batch_ms = (time.perf_counter() - t0) * 1e3
    return {"times": out, "device": dev_ms,
            "bounds": bounds(preps, stats[:, 0], bt.Lm), "s_write": s_write,
            "chain": chain,
            "library": library, "library_device": library_dev,
            "library_max_abs_diff": lib_err, "exact_s": exact,
            "s_prep_plan": plan_s_prep(*bt.g2T.shape),
            "s_plan": plan_s(B, bt.g1T.shape[1], n1max, n2max),
            "walks": walks,
            "chase_sweep": chase_sweep, "plan": bt.plan, "sweep": sweep,
            "native_ms": native_ms, "batch_ms": batch_ms}


def phase_times(dev, largest, root):
    t0 = time.perf_counter()
    floors = card_floors(dev)
    say("floors", t0, **{k: "%.7f" % v for k, v in floors.items()})
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
    cj = lambda d: json.dumps(d, separators=(",", ":"))
    r4 = lambda d: {k: round(v, 5) for k, v in d.items()}
    for shape, (items, rk, rp) in shapes.items():
        r = res[shape] = kernel_times(items, dev, rk, rp, floors)
        n1 = [it[0].size for it in items]
        n2 = [it[1].size for it in items]
        say("times:" + shape, t0, pairs=len(items),
            nodes="%d-%dx%d-%d" % (min(n1), max(n1), min(n2), max(n2)),
            native_align_node_ms="%.3f" % r["native_ms"],
            device_batch_wall_ms="%.3f" % r["batch_ms"],
            fill_plan=cj(r["plan"]._asdict()),
            fill_sweep_ms=cj(r4(r["sweep"])),
            bound_ms_by_old=cj({k: "%.5f/%s/%.5f" % v
                                for k, v in r["bounds"].items()}),
            chase_chain_bound_ms=cj(r4(r["chain"])),
            chase_walks=cj(r["walks"]),
            chase_sweep_device_ms=cj(r4(r["chase_sweep"])),
            s_prep_plan=cj(r["s_prep_plan"]._asdict()),
            s_plan=cj(r["s_plan"]._asdict()),
            s_padded_write_ms=cj(r4(r["s_write"])),
            s_prep_library_ms="%.4f" % r["library"]["s_prep"],
            s_prep_library_device_ms="%.4f" % r["library_device"]["s_prep"],
            s_prep_library_max_abs_diff="%.3g" % r["library_max_abs_diff"],
            exact_s_call_device_ms=cj({k: "%.4f/%.4f" % v
                                        for k, v in r["exact_s"].items()}),
            device_ms=cj(r4(r["device"])),
            **{k: "%.4f/%.4f/%.4f/%.4f" % v for k, v in r["times"].items()})
        t0 = time.perf_counter()
    return res, floors


def fasta_codes(path):
    """NW codes of a FASTA's sequences in name order, the start Met
    stripped as the CLI strips it: (codes [n, L] uint8, lengths [n])."""
    seqs, _ = read_fasta(path)
    met = AA_SPEC.encode("M")[0]
    codes = []
    for name in sorted(seqs):
        enc = AA_SPEC.encode(seqs[name])
        if len(enc) and enc[0] == met:
            enc = enc[1:]
        codes.append(_seq_codes(AA_SPEC, enc))
    lens = np.array([len(c) for c in codes], np.int32)
    cm = np.zeros((len(codes), lens.max()), np.uint8)
    for i, c in enumerate(codes):
        cm[i, :len(c)] = c
    return cm, lens


def all_pairs(cm, lens):
    pi, pj = np.triu_indices(len(lens), 1)
    return cm[pi], cm[pj], lens[pi], lens[pj]


def dpx_rates():
    """Operations a second of __viaddmax_s32 and __vibmax_s32 on this card:
    pgm_dpx_rate's 8 independent chains a thread, 8 blocks of 256 threads
    an SM, the time per round from two round counts."""
    L = _build.lib()
    sink = torch.zeros(1, dtype=torch.int32, device="cuda")
    blocks = 8 * torch.cuda.get_device_properties(0).multi_processor_count
    rates = {}
    for mode, name in ((0, "viaddmax"), (1, "vibmax")):
        t = [min(time_cuda(lambda: _build.launch(
            (), L.pgm_dpx_rate, mode, blocks, rounds, _build.ptr(sink)), 3)
            for _ in range(2)) for rounds in (1024, 9216)]
        rates[name] = blocks * 256 * 8 * 8192 / ((t[1] - t[0]) / 1e3)
    return rates


def nw_bound(l1, l2, T, dim, code_bytes, dpx):
    """(bound_ms, bound_by, bound_old_ms) of D2 on these pairs: each pair's
    codes, the lengths and the table in once, counts and gaps out once;
    NW_CELL_OPS a cell, timed as the largest of the int32 ones at
    INT32_OPS_S, the DPX ones at the ``dpx`` rates (dpx_rates) and all of
    them at one issue a lane and clock (F32_INSTR_S): the least time
    whether or not the DPX maxima share the int32 lanes.  bound_old_ms:
    NW_CELL_OPS_OLD int32 operations a cell (the first form's reckoning)."""
    B = len(l1)
    by = (code_bytes * int(l1.sum() + l2.sum()) + 8 * B + 4 * T * T
          + 4 * B * dim * dim + 4 * B)
    cells = float((l1.astype(np.int64) * l2).sum())
    n = {k: sum(v.values()) for k, v in NW_CELL_OPS.items()}
    to = cells * max(n["int32"] / INT32_OPS_S,
                     n["viaddmax"] / dpx["viaddmax"]
                     + n["vibmax"] / dpx["vibmax"],
                     sum(n.values()) / F32_INSTR_S) * 1e3
    tb = by / HBM_BYTES_S * 1e3
    old = max(tb, cells * NW_CELL_OPS_OLD / INT32_OPS_S * 1e3)
    return max(tb, to), "bytes" if tb >= to else "operations", old


def nw_check(name, arrs, go, ge, dim, dev, plain=True, host=True, reps=0,
             dpx=None):
    """D2 against nw_torch (``plain``) and native.nw_counts_native
    (``host``), bit for bit; with ``reps``, its call and device times (and
    the plain version's) and its bound under the ``dpx`` rates."""
    s1, s2, l1, l2, sc = arrs
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrs]
    plan = plan_nw(len(l1), sc.shape[0], s1.shape[1], s2.shape[1], dim,
                   (sc.min(), sc.max()), s1.itemsize)
    c, g = nw_counts(*args, go, ge, dim, plan=plan)
    torch.cuda.synchronize()
    if host:
        cn, gn = native.nw_counts_native(s1, s2, l1, l2, sc, go, ge, dim)
        diff("nw", c.long().cpu(), torch.from_numpy(cn).long(),
             "%s counts vs native" % name)
        diff("nw", g.long().cpu(), torch.from_numpy(gn).long(),
             "%s gaps vs native" % name)
    out = {"pairs": len(l1), "cells": int((l1.astype(np.int64) * l2).sum()),
           "rows": plan.rows, "plan": plan}
    if plain:
        fn = lambda: nw_torch(*args, go, ge, dim)
        if reps:
            (p0, p1), (ct, gt) = time_plain(fn, 1)
            out["plain_ms"] = min(p0, p1)
        else:
            ct, gt = fn()
        diff("nw", c, ct, name + " counts")
        diff("nw", g, gt, name + " gaps")
    if reps:
        kern = lambda: nw_counts(*args, go, ge, dim, plan=plan)
        out["ms"] = min(time_cuda(kern, reps) for _ in range(2))
        out["device_ms"] = min(device_time(kern, reps) for _ in range(2))
        out["bound_ms"], out["bound_by"], out["bound_old_ms"] = nw_bound(
            l1, l2, sc.shape[0], dim, s1.itemsize, dpx)
    return out


def nw_sass():
    """Opcode counts of D2's SASS at R = 4 (uint8 codes, with the walk), and
    of the DPX rate probe; both blocks written to chiprun_out/."""
    out = {}
    for key, pat in (("nw_R4", r"nw_kernelIhLi4ELb1E"),
                     ("dpx_viaddmax", r"dpx_rate_kernelILi0E"),
                     ("dpx_vibmax", r"dpx_rate_kernelILi1E")):
        ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9]+)",
                         kernel_sass(pat, "sass_%s.txt" % key))
        out[key] = {op: ops.count(op) for op in sorted(set(ops))
                    if op.startswith(("VI", "SHFL", "PRMT", "I2I", "SGXT"))}
        out[key]["all"] = len(ops)
    return out


def phase_nw(dev):
    """D2 against nw_torch and the native tier on fam100's 4,950 pairs, 8
    random pairs of 2000 x 1980, the strip-edge pairs (checks.NW_STRIP_N1
    x NW_STRIP_N2, 128 copies) and small batches under the codon (62
    codes, dim 61) and DNA (int32 codes) tables and a random asymmetric
    table with pairs of unequal and of zero length; timed at the first two
    and on fam500's 124,750 pairs (against the native tier on the first
    4,096), where the card's rate and the host's are measured.  The bound
    takes the DPX rates measured here (dpx_rates); the SASS's DPX, shuffle
    and byte-extract counts are reported."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(23)
    aa = _load_scoring("aa")
    go, ge = GAP_PARAMS["aa"]
    dpx = dpx_rates()
    sass = nw_sass()
    res = {}
    cm100, lens100 = fasta_codes(FIX + "/fam100.fasta")
    res["fam100"] = nw_check("fam100", (*all_pairs(cm100, lens100), aa), go,
                             ge, 20, dev, reps=20, dpx=dpx)
    s1 = rng.integers(0, 21, (8, 2000)).astype(np.uint8)
    s2 = rng.integers(0, 21, (8, 1980)).astype(np.uint8)
    res["8x2000x1980"] = nw_check(
        "8x2000x1980", (s1, s2, np.full(8, 2000, np.int32),
                        np.full(8, 1980, np.int32), aa), go, ge, 20, dev,
        reps=3, dpx=dpx)
    asym = rng.integers(-9, 12, (21, 21)).astype(np.int32)
    other = {}
    other["strip_edges"] = nw_check(
        "strip_edges", (*checks.nw_strip_edge_pairs(rng, 128), asym), go, ge,
        20, dev)
    l1 = rng.integers(0, 90, 96).astype(np.int32)
    l2 = rng.integers(0, 90, 96).astype(np.int32)
    l1[0] = l2[1] = l1[2] = l2[2] = 0
    other["asymmetric"] = nw_check(
        "asymmetric", (rng.integers(0, 21, (96, 90)).astype(np.uint8),
                       rng.integers(0, 21, (96, 70)).astype(np.uint8),
                       l1, np.minimum(l2, 70), asym), go, ge, 20, dev)
    other["codon"] = nw_check(
        "codon", (rng.integers(0, 62, (40, 150)).astype(np.uint8),
                  rng.integers(0, 62, (40, 140)).astype(np.uint8),
                  np.full(40, 150, np.int32),
                  rng.integers(100, 141, 40).astype(np.int32),
                  _load_scoring("codon")), *GAP_PARAMS["codon"], 61, dev)
    other["dna"] = nw_check(
        "dna", (rng.integers(0, 5, (40, 160)).astype(np.int32),
                rng.integers(0, 5, (40, 161)).astype(np.int32),
                rng.integers(120, 161, 40).astype(np.int32),
                np.full(40, 161, np.int32), _load_scoring("dna")),
        *GAP_PARAMS["dna"], 4, dev)
    # fam500: the card's rate on all pairs, the native tier on a slice
    arrs = (*all_pairs(*fasta_codes(FIX + "/fam500.fasta")), aa)
    other["fam500[:4096]"] = nw_check(
        "fam500[:4096]", tuple(a[:4096] for a in arrs[:4]) + (aa,), go, ge,
        20, dev, plain=False)
    res["fam500"] = nw_check("fam500", arrs, go, ge, 20, dev, plain=False,
                             host=False, reps=2, dpx=dpx)
    # the native tier's rate on fam100's pairs, all threads
    a100 = (*all_pairs(cm100, lens100), aa)
    t1 = time.perf_counter()
    native.nw_counts_native(*a100, go, ge, 20)
    nat_s = time.perf_counter() - t1
    rates = {"NW_DEVICE_RATE": res["fam500"]["cells"]
             / (res["fam500"]["device_ms"] / 1e3),
             "NW_NATIVE_RATE": res["fam100"]["cells"] / nat_s
             / native.n_threads()}
    cj = lambda d: json.dumps(d, separators=(",", ":"))
    say("nw", t0, vs_plain="bit-identical", vs_native="bit-identical",
        shapes=",".join(list(res) + list(other)),
        rows=cj({k: r["rows"] for k, r in {**res, **other}.items()}),
        dpx_ops_s=cj({k: float("%.4g" % v) for k, v in dpx.items()}),
        int32_ops_s="%.4g" % INT32_OPS_S, sass=cj(sass),
        native_threads=native.n_threads(), native_fam100_s="%.4f" % nat_s,
        **{k: cj({kk: (round(v, 5) if isinstance(v, float) else
                       (v._asdict() if hasattr(v, "_asdict") else v))
                  for kk, v in r.items()}) for k, r in res.items()},
        **{k: "%.4g" % v for k, v in rates.items()})
    return res, rates


def msa_stats_inputs(path):
    """An alignment's values [N, L] int32, gap mask [N, L] uint8 and all
    its pairs, rows in name order."""
    seqs, _ = read_fasta(path)
    rows = [np.frombuffer(seqs[n].encode(), np.uint8).astype(np.int16)
            for n in sorted(seqs)]
    vals = np.stack([AA_SPEC.values(r) for r in rows]).astype(np.int32)
    gapm = np.stack([AA_SPEC.is_gap(r) for r in rows]).astype(np.uint8)
    pi, pj = np.triu_indices(len(rows), 1)
    return vals, gapm, pi.astype(np.int32), pj.astype(np.int32)


def masked_onehot(vals, gapm, rows, cb, chunk=8192):
    """float32 [P, L, cb]: one-hot of the rows' values in [0, cb), zero
    where gapped (the library call's operand, built in chunks)."""
    P, L = rows.shape[0], vals.shape[1]
    out = torch.empty((P, L, cb), dtype=torch.float32, device=vals.device)
    for s in range(0, P, chunk):
        r = rows[s:s + chunk].long()
        v, g = vals[r], gapm[r].bool()
        ok = ~g & (v >= 0) & (v < cb)
        out[s:s + chunk] = torch.nn.functional.one_hot(
            torch.where(ok, v, cb).long(), cb + 1)[..., :cb].float()
    return out


def ops_ms(ops):
    """Milliseconds for ``ops`` ({"int32": n, "bits": n} lane operations)
    at the rate each issues at, or at one issue a lane and clock for all
    of them, whichever is longer."""
    return max(ops["int32"] / INT32_OPS_S, ops["bits"] / BITS_OPS_S,
               (ops["int32"] + ops["bits"]) / F32_INSTR_S) * 1e3


def bound_of(by, ops):
    return bound_of_rates(by, ops_ms(ops) / 1e3)


def bound_of_rates(by, ops_s):
    """(bound ms, what bounds it) of ``by`` bytes moved and ``ops_s``
    seconds of operations at their rate."""
    tb, to = by / HBM_BYTES_S * 1e3, ops_s * 1e3
    return max(tb, to), "bytes" if tb >= to else "operations"


def pair_pack_bound(N, L):
    """(bound_ms, bound_by) of the pack: the alignment read once (int32
    values, byte gap flags), the bit planes and the value bytes written
    once; PAIR_PACK_OPS a column of every padded row."""
    W = words(L)
    return bound_of(5 * N * L + 40 * N * W,
                    {k: N * 32 * W * sum(v.values())
                     for k, v in PAIR_PACK_OPS.items()})


def pair_stats_bound(N, L, P, cb, counted, width):
    """(bound_ms, bound_by, bound_old_ms) of D1 as the main path calls it
    (pack and statistics): the alignment and the pair lists read once,
    the counts (``width`` bytes each) and the gaps written once;
    PAIR_WORD_OPS a word of every pair, PAIR_COUNT_OPS a counted column
    (``counted``, the counts' sum in this run), PAIR_PACK_OPS a column of
    every padded row.  bound_old_ms: the first form's reckoning, int32
    counts and PAIR_COL_OPS_OLD a pair-column."""
    W = words(L)
    ops = {k: P * W * sum(PAIR_WORD_OPS[k].values())
           + counted * sum(PAIR_COUNT_OPS[k].values())
           + N * 32 * W * sum(PAIR_PACK_OPS[k].values())
           for k in ("int32", "bits")}
    bound, by = bound_of(5 * N * L + 8 * P + width * P * cb * cb + 4 * P,
                         ops)
    old = max((5 * N * L + 8 * P + 4 * P * cb * cb + 4 * P) / HBM_BYTES_S,
              float(P) * L * PAIR_COL_OPS_OLD / INT32_OPS_S) * 1e3
    return bound, by, old


def pair_stats_inputs():
    """The synthetic alignments of checks.pair_stats_msa (every alphabet x
    mask, 8 rows of 2061 columns, and DNA counted to 5 values), and one of
    2^16 + 4465 columns at 8 rows, whose counts are int32: name -> (vals,
    gapm, pi, pj, cb)."""
    out = {}
    for alpha in checks.PAIR_ALPHABETS:
        for mask in checks.PAIR_MASKS:
            out["%s_%s" % (alpha, mask)] = checks.pair_stats_msa(alpha, mask)
    out["long_8x70001"] = checks.pair_stats_msa("aa", "runs_across_words",
                                                L=70001)
    # a histogram of 25 counts, a number of bytes no multiple of 4
    out["dna_cb5"] = checks.pair_stats_msa("dna", "x_residues")[:2] + (5,)
    res = {}
    for name, (vals, gapm, cb) in out.items():
        pi, pj = (a.astype(np.int32) for a in np.triu_indices(len(vals), 1))
        res[name] = (vals, gapm, pi, pj, cb)
    return res


def host_batch(fn, vals, gapm, pi, pj, cb):
    """``fn`` (a host batch of pair statistics) over the prealigned stage's
    blocks, on the operands the stage gives it (int32 values, bool flags):
    the counts and gap openings of every pair, and the seconds."""
    v, g = vals.astype(np.int32), gapm.astype(bool)
    a, b = pi.astype(np.intp), pj.astype(np.intp)
    step = host_block_pairs(vals.shape[1])
    t1 = time.perf_counter()
    out = [fn(v, g, a[s:s + step], b[s:s + step], cb, cb)
           for s in range(0, len(pi), step)]
    secs = time.perf_counter() - t1
    return [torch.from_numpy(np.concatenate(x)) for x in zip(*out)], secs


def pair_stats_check(name, vals, gapm, pi, pj, cb, dev):
    """D1 (pack and statistics, the counts under both widths where the
    alignment allows 16 bits) against pair_pack_torch, pair_stats_torch
    and the host batch (over the prealigned stage's blocks: the native
    library's, and the numpy body), bit for bit.  Returns the device
    tensors, the packed rows, the plain result and the host's seconds:
    the native batch's least of three runs, and the numpy body's one."""
    N, L = vals.shape
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in (vals, gapm, pi, pj)]
    packed = pair_pack(args[0], args[1], cb)
    torch.cuda.synchronize()
    for k, x, y in zip("GKC", packed, pair_pack_torch(args[0], args[1], cb)):
        diff("pair_pack", x, y, "%s %s" % (name, k))
    ct, gt = pair_stats_torch(*args, cb)
    if native.lib() is None:
        raise AssertionError("the native library did not build")
    (ch, gh), host_s = host_batch(_pair_stats_batch_host, vals, gapm, pi, pj,
                                  cb)
    host_s = min([host_s] + [host_batch(_pair_stats_batch_host, vals, gapm,
                                        pi, pj, cb)[1] for _ in range(2)])
    (cn, gn), numpy_s = host_batch(_pair_stats_batch_numpy, vals, gapm, pi,
                                   pj, cb)
    diff("pair_stats", ch, cn, name + " host counts vs numpy")
    diff("pair_stats", gh, gn, name + " host gaps vs numpy")
    types = (torch.int32,) + ((torch.uint16,) if L < 1 << 16 else ())
    for ty in types:
        c, g = pair_stats(*args, cb, count_type=ty)
        torch.cuda.synchronize()
        if c.dtype != ty:
            raise AssertionError("%s: D1 gave %s counts" % (name, c.dtype))
        what = "%s %s" % (name, str(ty).split(".")[-1])
        diff("pair_stats", c, ct, what + " counts")
        diff("pair_stats", g, gt, what + " gaps")
        diff("pair_stats", c.cpu(), ch, what + " counts vs host")
        diff("pair_stats", g.cpu(), gh, what + " gaps vs host")
    if ct.dtype != count_dtype(L):
        raise AssertionError("%s: %s counts from the plain version"
                             % (name, ct.dtype))
    return args, packed, (ct, gt), (host_s, numpy_s)


def lane_loads(K, pi, pj, W):
    """D1's counted columns per lane (checks.pair_lane_loads): the mean
    over pairs of a busy lane's mean and of the fullest lane, the largest
    lane of any pair, and the mean over pairs of the bits the lanes walk
    when they take each word of their runs in step."""
    loads, trips = checks.pair_lane_loads(K.cpu().numpy().view(np.uint32),
                                          pi, pj)
    busy = -(-W // -(-W // 32)) if W else 1
    return {"lane_mean": float(loads.sum(1).mean() / busy),
            "lane_max_mean": float(loads.max(1).mean()),
            "lane_max": int(loads.max()),
            "word_steps_mean": float(trips.mean())}


def parent_times(parent, inputs):
    """D1's device ms of the tree at ``parent`` on ``inputs`` (name ->
    (vals, gapm, pi, pj, cb)), from pair_stats_time.py in its own
    process."""
    with tempfile.TemporaryDirectory(dir=OUT) as tmp:
        files = []
        for name, (vals, gapm, pi, pj, cb) in inputs.items():
            f = os.path.join(tmp, name + ".npz")
            np.savez(f, vals=vals, gapm=gapm, pi=pi, pj=pj, cb=cb)
            files.append("%s=%s" % (name, f))
        out = subprocess.run(
            [sys.executable, os.path.join(REPO, "pair_stats_time.py"),
             parent, *files], capture_output=True, text=True, timeout=900)
    if out.returncode != 0:
        raise AssertionError("pair_stats_time.py on %s failed:\n%s"
                             % (parent, out.stderr[-3000:]))
    return json.loads(out.stdout.strip().splitlines()[-1])


def phase_pair_stats(dev, msas, parent=None):
    """D1 (the pack and the statistics) against pair_pack_torch,
    pair_stats_torch and the host batch path (_pair_stats_batch_host, the
    native library's, and _pair_stats_batch_numpy), bit for bit, on every
    pair of each alignment of ``msas`` and of pair_stats_inputs(), its
    counts in 16 and in 32 bits.  On ``msas``: the host batches' seconds
    over the stage's blocks (native and numpy),
    the call and device times of D1, of the pack and of the statistics
    alone (in 16 and 32 bits, and with no counted column: the gap scan),
    the counted share of pair-columns, how the counted columns fall on the
    lanes, the bound beside the first form's, one masked one-hot torch.bmm
    (the counts only), and with ``parent`` (a checkout of an earlier tree)
    that tree's D1 timed before and after this one's."""
    t0 = time.perf_counter()
    cb = 20
    checked = {}
    for name, inp in pair_stats_inputs().items():
        pair_stats_check(name, *inp, dev)
        checked[name] = "%dx%d" % inp[0].shape
    inputs = {name: (*msa_stats_inputs(path), cb) for name, path in msas}
    before = parent_times(parent, inputs) if parent else {}
    res, res_pack = {}, {}
    for name, (vals, gapm, pi, pj, _) in inputs.items():
        N, L = vals.shape
        P, W = len(pi), words(L)
        args, packed, (ct, _), (host_s, numpy_s) = pair_stats_check(
            name, vals, gapm, pi, pj, cb, dev)
        (p0, p1), _ = time_plain(lambda: pair_stats_torch(*args, cb), 1)
        kern = lambda: pair_stats(*args, cb)
        dev_ms = lambda fn: min(device_time(fn, 20) for _ in range(2))
        nocount = (packed[0], torch.zeros_like(packed[1]), packed[2])
        counted = int(ct.long().sum())
        r = {"rows": N, "columns": L, "pairs": P, "host_s": host_s,
             "host_numpy_s": numpy_s, "host_threads": native.n_threads(),
             "plain_ms": min(p0, p1),
             "ms": min(time_cuda(kern, 20) for _ in range(2)),
             "device_ms": dev_ms(kern),
             "pack_device_ms": dev_ms(lambda: pair_pack(*args[:2], cb)),
             "stats_device_ms": dev_ms(lambda: pair_stats(
                 *args, cb, packed=packed)),
             "stats_int32_device_ms": dev_ms(lambda: pair_stats(
                 *args, cb, packed=packed, count_type=torch.int32)),
             "stats_gap_scan_device_ms": dev_ms(lambda: pair_stats(
                 *args, cb, packed=nocount)),
             "counted_share": counted / (P * L),
             **lane_loads(packed[1], pi, pj, W)}
        r["bound_ms"], r["bound_by"], r["bound_old_ms"] = pair_stats_bound(
            N, L, P, cb, counted, ct.element_size())
        oh1 = masked_onehot(args[0], args[1], args[2], cb).transpose(1, 2)
        oh2 = masked_onehot(args[0], args[1], args[3], cb)
        lib = lambda: torch.bmm(oh1, oh2)
        if not torch.equal(lib().long(), ct.long()):
            raise AssertionError("%s: the masked one-hot bmm differs from "
                                 "D1's counts" % name)
        r["library_ms"] = min(time_cuda(lib, 5) for _ in range(2))
        r["library_device_ms"] = dev_ms(lambda: torch.bmm(oh1, oh2))
        del oh1, oh2
        pack = lambda: pair_pack(*args[:2], cb)
        (q0, q1), _ = time_plain(lambda: pair_pack_torch(*args[:2], cb), 3)
        rp = res_pack[name] = {
            "plain_ms": min(q0, q1),
            "ms": min(time_cuda(pack, 20) for _ in range(2)),
            "device_ms": r["pack_device_ms"]}
        rp["bound_ms"], rp["bound_by"] = pair_pack_bound(N, L)
        res[name] = r
    if parent:
        after = parent_times(parent, inputs)
        for name, r in res.items():
            r["parent_device_ms"] = [before[name], after[name]]
    big = res[msas[-1][0]]
    work = big["pairs"] * big["columns"]
    rates = {"PAIR_STATS_DEVICE_RATE": work / (big["device_ms"] / 1e3),
             "PAIR_STATS_HOST_RATE": work / big["host_s"]
             / big["host_threads"],
             "PAIR_STATS_NUMPY_RATE": work / big["host_numpy_s"]}
    cj = lambda d: json.dumps({k: round(v, 5) if isinstance(v, float) else v
                               for k, v in d.items()}, separators=(",", ":"))
    say("pair_stats", t0, vs_plain="bit-identical", vs_host="bit-identical",
        widths="uint16,int32", checked=cj(checked),
        **{k: cj(r) for k, r in res.items()},
        **{"pack_" + k: cj(r) for k, r in res_pack.items()},
        **{k: "%.4g" % v for k, v in rates.items()})
    return res, res_pack, rates


def phase_angle(dev):
    """The float32 products of ``--engine device``: the angle distances'
    k-mer Gram on the card (TF32 off) against numpy's int64 Gram on fam500,
    identical; the CS window scores and mix on the card against the host's
    float64 path on fam6 with cs16.lib, within 1e-5."""
    t0 = time.perf_counter()
    seqs, _ = read_fasta(FIX + "/fam500.fasta")
    enc = {n: AA_SPEC.encode(s) for n, s in seqs.items()}
    counts, _ = kmer_counts(AA_SPEC, enc, sorted(enc), AA_SPEC.kmer_k)
    want = counts.astype(np.int64) @ counts.astype(np.int64).T
    full_float32()
    C = torch.from_numpy(counts.astype(np.float32)).to(dev)
    G = torch.matmul(C, C.T)
    if not np.array_equal(G.cpu().numpy().astype(np.int64), want):
        raise AssertionError("fam500: the card's k-mer Gram differs from "
                             "numpy's int64 Gram")
    ms = min(time_cuda(lambda: torch.matmul(C, C.T), 20) for _ in range(2))
    seqs, _ = read_fasta(FIX + "/fam6.fasta")
    items = [(AA_SPEC.encode(s), checks.model(0.3)) for s in seqs.values()]
    host, card = (CSProfileLibrary(FIX + "/cs16.lib") for _ in range(2))
    host.prime_profiles(items)
    card.prime_profiles(items, "device", dev)
    cs_err = max(float(np.max(np.abs(card._cache[card._key(*it)]
                                     - host._cache[host._key(*it)])))
                 for it in items)
    if not cs_err < 1e-5:
        raise AssertionError("fam6: the card's CS mix is %g from the host's"
                             % cs_err)
    say("angle", t0, shape="%dx%d" % counts.shape, vs_int64="identical",
        gram_ms="%.4f" % ms, max_entry=int(want.max()),
        cs_mix_fam6_max_abs_vs_host="%.3g" % cs_err)


def phase_rates(largest, native_ms, rates):
    """The calibration auto probes and the rates engine_policy.py holds,
    measured in this run, with the host's CPU: ``native_ms`` is the native
    tier's alignment of fam100's largest level, one thread."""
    t0 = time.perf_counter()
    cells = sum(it[0].size * it[1].size for it in largest)
    rates["NATIVE_CELLS_PER_SEC"] = cells / (native_ms / 1e3)
    engine_policy.calibration.cache_clear()
    calib = engine_policy.calibration()
    cpu = {"Architecture": platform.machine()}
    with contextlib.suppress(OSError, subprocess.SubprocessError):
        out = subprocess.run(["lscpu"], capture_output=True, text=True,
                             timeout=30).stdout
        note("== lscpu", out)
        for ln in out.splitlines():
            key = ln.split(":", 1)[0].strip()
            if key in ("Architecture", "Vendor ID", "Model name",
                       "CPU family", "Model", "Stepping",
                       "Hypervisor vendor"):
                cpu[key] = ln.split(":", 1)[1].strip()
    say("rates", t0, cpu=json.dumps(cpu, separators=(",", ":")),
        cores=len(os.sched_getaffinity(0)),
        native_threads=native.n_threads(),
        calibration=json.dumps(calib, separators=(",", ":")),
        measured=json.dumps({k: float("%.4g" % v) for k, v in rates.items()},
                            separators=(",", ":")),
        engine_policy=json.dumps({k: getattr(engine_policy, k)
                                  for k in rates}, separators=(",", ":")))
    return rates


def dist_row(k, launches, res, main_shape):
    """The kernels line's row of a distance kernel: the main shape's
    numbers bare, every other shape's with its name as suffix."""
    src, repl = KERNELS[k]
    row = {"name": k, "route": "cuda", "source": src, "replaces": repl,
           "launches": launches[k], "max_abs_err": max_err[k]}
    for shape, r in res.items():
        sfx = "" if shape == main_shape else "_" + shape
        for key in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                    "bound_old_ms", "rows", "library_ms",
                    "library_device_ms", "pack_device_ms", "stats_device_ms",
                    "stats_int32_device_ms", "stats_gap_scan_device_ms",
                    "counted_share", "lane_mean", "lane_max_mean",
                    "word_steps_mean", "parent_device_ms"):
            if key in r:
                row[key + sfx] = r[key]
        if main_shape == shape:
            row.setdefault("library_ms", None)
    return row


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="a checkout of an earlier tree: phase "
                    "pair_stats times its D1, phases fam1000_default and "
                    "reroot (fam500 -r -i 0) run it, beside this tree's")
    parent = ap.parse_args().parent
    if parent and not os.path.exists(os.path.join(parent, "prographmsa_tpu_"
                                                  "torch")):
        raise SystemExit("chip_smoke: --parent %s holds no port" % parent)
    name, smi = phase_device()
    dev = torch.device("cuda")
    phase_build()
    phase_s(dev)
    phase_fill_chase(dev)
    phase_wide_pair(dev)
    wide_shape, wide = phase_wide_slots(dev)
    os.makedirs(OUT, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=OUT) as tmp:
        launches, launches_c2, largest = phase_fam100(dev, tmp)
        phase_corpus(tmp)
        runs = {}
        launches_reroot = phase_reroot(tmp, runs, parent)
        phase_walls(tmp, runs)
        phase_threads(tmp, runs, smi)
        phase_start(runs)
        phase_fam1000_default(tmp, parent)
        ctr2000 = phase_fam2000_default(tmp)
        launches_resume = phase_resume(tmp, runs, smi)
        launches500, root, sum500, sum500_dev, levels500 = phase_levels(
            dev, tmp)
        launches_mesh = phase_mesh(tmp, levels500, runs, smi)
        res_nw, rates = phase_nw(dev)
        res_ps, res_pack, rates_ps = phase_pair_stats(dev, (
            ("c2_fam100", GOLD + "/c2_fam100.fasta"),
            ("fam500_i0", os.path.join(tmp, "l500.fasta"))), parent)
    phase_angle(dev)
    res, floors = phase_times(dev, largest, root)
    phase_rates(largest, res["fam100_level"]["native_ms"],
                {**rates, **rates_ps})
    stray = [m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "prographmsa_tpu" or m.startswith("prographmsa_tpu.")]
    if stray:
        raise AssertionError("the port imported %s" % stray)
    with open(os.path.join(OUT, "chip_smoke_detail.txt"), "w") as f:
        f.write("\n".join(detail) + "\n")
    kern = []
    main_shape = "fam100_level"
    for k in DP_KERNELS:
        src, repl = KERNELS[k]
        row = {"name": k, "route": "cuda", "source": src, "replaces": repl,
               "launches": launches[k], "launches_c2_fam100": launches_c2[k],
               "launches_fam500": launches500[k],
               "launches_reroot_fam100": launches_reroot["r_t_fam100"][k],
               "launches_reroot_fam500": launches_reroot["r_fam500_i0"][k],
               "launches_mesh": launches_mesh[k],
               "launches_resume": launches_resume[k],
               "max_abs_err": max_err[k],
               "ms_fam500_levels_sum": sum500[k],
               "device_ms_fam500_levels_sum": sum500_dev[k],
               "launch_floor_ms": floors["launch_floor_ms"]}
        for shape, r in res.items():
            p0, k0, p1, k1 = r["times"][k]
            sfx = "" if shape == main_shape else "_" + shape
            row["ms" + sfx] = min(k0, k1)
            row["device_ms" + sfx] = r["device"][k]
            row["plain_ms" + sfx] = min(p0, p1)
            (row["bound_ms" + sfx], row["bound_by" + sfx],
             row["bound_old_ms" + sfx]) = r["bounds"][k]
            row["library_ms" + sfx] = r["library"].get(k)
            row["library_device_ms" + sfx] = r["library_device"].get(k)
            if k == "fill":
                row["blocks_per_pair" + sfx] = r["plan"].blocks_per_pair
            if k == "chase":
                row["chain_ms" + sfx] = r["chain"]["chain_ms"]
                row["chain_l2_ms" + sfx] = r["chain"]["chain_l2_ms"]
                row["window_fills" + sfx] = r["walks"]["window_fills"]
                row["steps" + sfx] = r["walks"]["steps"]
            if k == "s":
                for name_, ms in r["s_write"].items():
                    row[name_ + sfx] = ms
                for name_, (call, device) in r["exact_s"].items():
                    row["exact_s_%s_ms%s" % (name_, sfx)] = call
                    row["exact_s_%s_device_ms%s" % (name_, sfx)] = device
        if k in wide:    # int64 code words: the census pair, fam2000
            row["shape_wide"] = wide_shape
            for key, v in wide[k].items():
                row[key + "_wide"] = v
            row["launches_wide_fam2000"] = ctr2000.get(
                "torch_launches_wide", 0)
            if k == "chase":
                row["chain_ms_wide"] = (wide[k]["steps"]
                                        * floors["shared_read_ms"])
                row["chain_l2_ms_wide"] = (wide[k]["steps"]
                                           * floors["l2_read_ms"])
        kern.append(row)
    # the distance kernels: launches from the free-tree run (c2_fam100)
    kern.append(dist_row("nw", launches_c2, res_nw, "fam100"))
    kern[-1]["launches_mesh"] = launches_mesh["nw"]
    kern.append(dist_row("pair_pack", launches_c2, res_pack, "c2_fam100"))
    kern.append(dist_row("pair_stats", launches_c2, res_ps, "c2_fam100"))
    for row in kern[-2:]:    # D1 on the re-trees of the free-tree -r run
        row["launches_reroot_free_fam100"] = \
            launches_reroot["r_fam100"][row["name"]]
    for row in kern[-3:]:    # the resumed free tree: D1, no D2
        row["launches_resume"] = launches_resume[row["name"]]
    print(json.dumps({"kernels": kern}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
