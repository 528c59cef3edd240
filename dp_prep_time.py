"""Host time of the card path's batch preparation: native against numpy.

The port's CLI runs once in this process with ``--device cpu``, and every
batch that the level driver sends to ``graph_dp_cuda.align_pairs_device``
is recorded and handed back whole, so the host tier aligns its pairs and
the output is the CLI's own (held against ``--golden`` when given).  Then,
on the recorded batches, each batch in turn: ``prep_pair`` over its pairs
and ``pack_pairs`` over its launches (``_launches``; on the CPU, so the
host arrays without a copy to a card) are timed with the native library
and with ``native.lib`` returning None, which runs the numpy bodies
(``slots._offset_costs_rep_numpy`` with ``inf_to_cap``,
``graph_dp_cuda._planes_numpy``), and the two are held bit for bit: slot
tables, every tensor of each ``Batch`` (viewed as integers, so -0.0
counts), its plan, ``Rmax`` and ``Lm``.  The same is done once inside
the CLI run, each batch as it comes (``in_run``): there, as in a run on
the card, the tables take memory new to the process, and the minor page
faults of its first touch are counted.

    python3 dp_prep_time.py [--repeat N] [--golden FILE] [CLI_ARGS...]

CLI_ARGS are the port CLI's own; the default is fam500's root search,
``--fasta -r -i 0 fixtures/fam500.fasta`` (golden
``fixtures/golden/fam500_r_i0.fasta``).  The threads are
``PROGRAPHMSA_THREADS`` (default: every core).  Prints one JSON line: the
batches, pairs and launches, the largest launch, the CLI run's wall (the
in-run timing included), for each body the seconds and page faults of
prep and of pack summed over the batches in the run and, after it, the
least of N rounds taken in turns (every round's sums beside it); exits 1
when the bodies disagree or the output differs from the golden.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import resource
import sys
import tempfile
import time

import numpy as np

DEFAULT = ["--fasta", "-r", "-i", "0", "fixtures/fam500.fasta"]


@contextlib.contextmanager
def numpy_bodies():
    """The batch preparation as without the native library."""
    from prographmsa_tpu_torch import native

    lib = native.lib
    native.lib = lambda: None
    try:
        yield
    finally:
        native.lib = lib


def prep(items):
    from prographmsa_tpu_torch.align import graph_dp_cuda as gdp

    return [gdp.prep_pair(k, *it) for k, it in enumerate(items)]


def pack(preps):
    """Each launch's Batch of the prepared pairs, as ``_launch_shares``
    cuts them on one shard."""
    from prographmsa_tpu_torch.align import graph_dp_cuda as gdp

    order = sorted([p for p in preps if not isinstance(p, str)],
                   key=lambda p: -(p.g1.size + p.g2.size))
    return [gdp.pack_pairs(chunk, "cpu") for chunk in gdp._launches(order)]


def _faults():
    """This process's minor page faults so far (first touches of new
    memory)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_minflt


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32,
                   8: np.uint64}[a.itemsize])


def same_preps(a, b):
    """Two lists of ``prep_pair`` results agree bit for bit."""
    if len(a) != len(b):
        return False
    for p, q in zip(a, b):
        if isinstance(p, str) or isinstance(q, str):
            if p != q:
                return False
            continue
        for f in ("o1", "C1", "rep1", "o2", "C2", "rep2"):
            x, y = getattr(p, f), getattr(q, f)
            if x.dtype != y.dtype or x.shape != y.shape \
                    or not np.array_equal(_bits(x), _bits(y)):
                return False
        if (p.idx, p.R, p.shb) != (q.idx, q.R, q.shb):
            return False
    return True


def same_batches(a, b):
    """Two lists of ``Batch`` agree bit for bit: tensors, plan, Rmax, Lm."""
    if len(a) != len(b):
        return False
    for x, y in zip(a, b):
        for f in x._fields:
            u, v = getattr(x, f), getattr(y, f)
            if hasattr(u, "numpy"):
                u, v = u.cpu().numpy(), v.cpu().numpy()
                if u.dtype != v.dtype or u.shape != v.shape \
                        or not np.array_equal(_bits(u), _bits(v)):
                    return False
            elif u != v:
                return False
    return True


def compare(batches, repeat=1):
    """Time prep and pack of ``batches`` (lists of align_pairs_device
    items) under both bodies, native first in odd rounds, count the minor
    page faults of each, and hold them bit for bit.  Returns {"native":
    {"prep_s": [...], "pack_s": [...], "prep_faults": [...],
    "pack_faults": [...]}, "numpy": {...}, "identical": bool, "launches":
    n, "largest": (pairs, opmax, n1max) of the launch with the largest
    C1T}: per round the sums over the batches."""
    keys = ("prep_s", "pack_s", "prep_faults", "pack_faults")
    times = {b: {k: [] for k in keys} for b in ("native", "numpy")}
    identical, launches, largest = True, 0, (0, 0, 0, 0)
    for r in range(repeat):
        sums = {b: [0] * 4 for b in times}
        for items in batches:
            got = {}
            for body in (("native", "numpy") if r % 2 == 0
                         else ("numpy", "native")):
                with (numpy_bodies() if body == "numpy"
                      else contextlib.nullcontext()):
                    f0, t0 = _faults(), time.perf_counter()
                    preps = prep(items)
                    f1, t1 = _faults(), time.perf_counter()
                    packed = pack(preps)
                    f2, t2 = _faults(), time.perf_counter()
                for k, v in enumerate((t1 - t0, t2 - t1, f1 - f0, f2 - f1)):
                    sums[body][k] += v
                got[body] = (preps, packed)
            (p_nat, b_nat), (p_num, b_num) = got["native"], got["numpy"]
            identical &= same_preps(p_nat, p_num) and \
                same_batches(b_nat, b_num)
            if r == 0:
                launches += len(b_nat)
                for bt in b_nat:          # the most entries of C1T
                    largest = max(largest, (bt.C1T.numel(), len(bt.n1),
                                            bt.C1T.shape[1],
                                            bt.C1T.shape[2]))
            del got, p_nat, b_nat, p_num, b_num
        for b in times:
            for k, v in zip(keys, sums[b]):
                times[b][k].append(v)
    return {**times, "identical": identical, "launches": launches,
            "largest": largest[1:]}


def record(cli_args, in_run=None):
    """Run the port's CLI in process on the CPU, every DP batch recorded
    and handed back to the host tier: (batches, output text, wall s).
    ``in_run`` (a function of a batch's items) sees each batch first,
    inside the run, where the memory it takes is new to the process."""
    from prographmsa_tpu_torch import cli
    from prographmsa_tpu_torch.align import graph_dp_cuda as gdp

    batches, orig = [], gdp.align_pairs_device

    def recording(items, device, mesh=None):
        if in_run is not None:
            in_run(items)
        batches.append(list(items))
        return [None] * len(items)

    gdp.align_pairs_device = recording
    try:
        with tempfile.TemporaryDirectory() as tmp:
            out = os.path.join(tmp, "out")
            t0 = time.perf_counter()
            with contextlib.redirect_stderr(io.StringIO()):
                rc = cli.main(cli_args + ["--device", "cpu", "-o", out])
            wall = time.perf_counter() - t0
            if rc != 0:
                raise SystemExit("dp_prep_time: the CLI run exited %d" % rc)
            with open(out) as f:
                text = f.read()
    finally:
        gdp.align_pairs_device = orig
    return batches, text, wall


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeat", type=int, default=3)
    ap.add_argument("--golden")
    args, cli_args = ap.parse_known_args()
    if not cli_args:
        cli_args = list(DEFAULT)
        args.golden = args.golden or "fixtures/golden/fam500_r_i0.fasta"
    from prographmsa_tpu_torch import native

    if native.lib() is None:
        raise SystemExit("dp_prep_time: the native library did not load")
    runs = []
    batches, text, wall = record(
        cli_args, lambda items: runs.append(compare([items])))
    same_output = None
    if args.golden:
        with open(args.golden) as f:
            same_output = f.read() == text
    res = compare(batches, args.repeat)
    in_run = {b: {k: sum(r[b][k][0] for r in runs) for k in res[b]}
              for b in ("native", "numpy")}
    identical = res["identical"] and all(r["identical"] for r in runs)
    line = {"cli": cli_args, "threads": native.n_threads(),
            "batches": len(batches),
            "pairs": sum(len(b) for b in batches), "cli_s": wall,
            "same_as_golden": same_output, "in_run": in_run,
            **res, "identical": identical}
    for b in ("native", "numpy"):
        for k in ("prep_s", "pack_s", "prep_faults", "pack_faults"):
            line["%s_%s" % (b, k)] = min(res[b][k])
    print(json.dumps(line))
    return 0 if identical and same_output is not False else 1


if __name__ == "__main__":
    sys.exit(main())
