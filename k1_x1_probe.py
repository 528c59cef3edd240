"""Probe of K1's launch path and of the code chase X1 on one NVIDIA card.

    python3 k1_x1_probe.py

What chip_smoke.py's table cannot show.  First the host's microseconds per
part of ``scores_cuda.s_prep`` (placement and argument checks, the planner,
the two ``torch.empty``, the stream query, the ``ctypes`` crossing) beside
the two ``torch.bmm`` that compute the same, then K1 and that library call
timed in turns at several repetition counts: a kernel of a few microseconds
reads as its launch path, and few repetitions read high.  Then X1's device
time (CUDA graph replay) under each code window and block size on three
synthetic batches (39 pairs of 8 nodes, which is what a launch costs before
its first step; 39 chains of about 205 nodes; 8 chains of 2000 x 1980) with
the steps and window fills of its walks.  X1's SASS goes to
chiprun_out/chase_sass.txt.  The last lines are the card's name and power
limit and PROBE OK.
"""

from __future__ import annotations

import time

import numpy as np
import torch

import chip_smoke as cs
from prographmsa_tpu_torch import _build, checks
from prographmsa_tpu_torch.align.chase_cuda import N_STATS, chase, plan_chase
from prographmsa_tpu_torch.align.fill_cuda import fill
from prographmsa_tpu_torch.align.scores_cuda import (exact_s, plan_s_prep,
                                                     s_plane, s_prep)
from prographmsa_tpu_torch.device import on_cuda


def host_us(fn, n=3000):
    """Host microseconds per call of ``fn`` (the device drains after)."""
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return round(t, 2)


def dump_sass():
    block = cs.kernel_sass("chase_kernel", "chase_sass.txt")
    print("chase_kernel SASS lines", block.count("\n"))


def probe_k1(bt, dev):
    B, dim, n2max = bt.g2T.shape
    f32 = torch.float32
    L, p = _build.lib(), _build.ptr
    plan = plan_s_prep(B, dim, n2max)
    t2, v2 = s_prep(bt.g2T, bt.M, bt.pi)
    Mt = bt.M.transpose(1, 2).contiguous()
    lib = lambda: (torch.bmm(Mt, bt.g2T),
                   torch.bmm(bt.pi[:, None, :], bt.g2T))
    k1 = lambda: s_prep(bt.g2T, bt.M, bt.pi)
    stream = _build._current_stream()
    print("host us per call", {
        "on_cuda": host_us(lambda: on_cuda(bt.g2T, bt.M, bt.pi)),
        "check_args": host_us(lambda: _build.check_args(
            "s_prep", (bt.g2T, f32, (B, dim, n2max)),
            (bt.M, f32, (B, dim, dim)), (bt.pi, f32, (B, dim)))),
        "plan_s_prep": host_us(lambda: plan_s_prep(B, dim, n2max)),
        "two_torch_empty": host_us(lambda: (
            torch.empty((B, dim, n2max), dtype=f32, device=dev),
            torch.empty((B, n2max), dtype=f32, device=dev))),
        "torch_current_stream": host_us(
            lambda: torch.cuda.current_stream().cuda_stream),
        "raw_current_stream": host_us(_build._current_stream),
        "ctypes_empty_grid": host_us(lambda: L.pgm_empty(stream)),
        "ctypes_s_prep": host_us(lambda: L.pgm_s_prep(
            p(bt.g2T), p(bt.M), p(bt.pi), B, dim, n2max, plan.threads,
            plan.dgroup, plan.xvec, p(t2), p(v2), stream)),
        "s_prep": host_us(k1), "two_bmm": host_us(lib),
        "exact_s": host_us(lambda: exact_s(
            bt.g1T, bt.g2T, bt.M, bt.pi, bt.mi, bt.n1, bt.n2), 300)})
    for reps in (5, 20, 200):
        print("call ms in turns (s_prep, two_bmm), %d repetitions" % reps,
              [(round(cs.time_cuda(k1, reps), 4),
                round(cs.time_cuda(lib, reps), 4)) for _ in range(3)])


def probe_x1(name, bt, dev):
    t2, v2 = s_prep(bt.g2T, bt.M, bt.pi)
    Sd = s_plane(bt.g1T, t2, v2, bt.pi, bt.mi, bt.n1, bt.n2)
    fo = fill(*cs.fill_args(Sd, bt), bt.plan)
    ca = cs.chase_args(bt)
    B, _, n1max = bt.g1T.shape
    opmax, n2max = bt.O1.shape[1], bt.g2T.shape[2]
    ms = {}
    for key, kw in [("w%d" % w, {"win": w}) for w in (8, 16, 32, 64)] + [
            ("t%d" % t, {"threads": t}) for t in (32, 128, 256)]:
        pl = plan_chase(B, opmax, n1max, n2max, **kw)
        ms[key] = round(min(cs.device_time(
            lambda: chase(fo, *ca, plan=pl), 5) for _ in range(2)), 4)
    stats = torch.zeros((B, N_STATS), dtype=torch.int32, device=dev)
    chase(fo, *ca, stats=stats)
    st = stats.cpu().numpy()
    print(name, "chase device ms", ms, "plan", plan_chase(B, opmax, n1max,
                                                          n2max),
          "longest_steps", int(st[:, 0].max()), "window_fills",
          int(st[:, 1].sum()), "boundary_replays", int(st[:, 2].sum()),
          flush=True)


def main():
    _, smi = cs.phase_device()
    dev = torch.device("cuda")
    cs.phase_build()
    dump_sass()
    rng = np.random.RandomState(3)
    m = checks.model(0.5)
    batches = {}
    for name, B, n1, n2 in (("39x8x8", 39, 6, 6), ("39x207x202", 39, 205, 200),
                            ("8x2000x1980", 8, 2000, 1980)):
        items, _ = checks.items_and_expected(
            [(checks.chain(checks.random_seq(rng, n1)),
              checks.chain(checks.random_seq(rng, n2)), m) for _ in range(B)])
        batches[name] = cs.pack(items, dev)[1]
    probe_k1(batches["39x207x202"], dev)
    for name, bt in batches.items():
        probe_x1(name, bt, dev)
    print(smi)
    print("PROBE OK")


if __name__ == "__main__":
    main()
