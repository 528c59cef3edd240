"""Process start of the port's CLI, step by step, in fresh processes.

    python3 startup_time.py [--runs N] [--device cuda|cpu] [--cells]
                            [--out DIR]

Each step is timed in N fresh processes (default 5); the JSON line holds
each step's median and range in seconds.  ``python -c pass`` is timed from
spawn to exit.  A second kind of process takes, in turn: ``import numpy``,
the port's CLI module, ``import torch``, ``torch.cuda.is_available()``, the
CUDA context (``torch.zeros(1, device="cuda")`` and a synchronize),
``_build.lib()`` (the kernel library, built by this script beforehand: the
source hash and ``ctypes.CDLL``), ``native.lib()``, and the port's CLI on
fam20 ``--mldist --nwdist`` in process twice, held to its golden
(c2_fam20), which launches all seven kernels.  Every launch of those two
runs is timed alone (a synchronize before and after it): a kernel's first
launch less the median of its launches in the second run is its first
launch's own cost (the lazy load of its module).  ``interpreter_s`` is spawn to the script's first line and
``exit_s`` the last line to the exit the parent sees: interpreter teardown,
the pools' shutdown, the context's release.  The host clock is the system's
monotonic clock, one for every process.  ``torch_bytecode`` says how many
of torch's modules an ``import torch`` compiled from source, and their
seconds, in two fresh processes in turn: the second compiles none when the
first could write its cache.

``--cells`` also runs the CLI, each run a process of its own, on t_fam100
and fam500 ``-i 0`` with ``--timings``, N runs each, with the host pool at
its default size and at ``PROGRAPHMSA_THREADS=1`` (where ``merge``,
``extend`` and ``clean`` are wall time, not sums over the pool's threads),
holds each output to its golden and prints each run's wall and phases.

On ``--device cpu`` the card's steps are left out.  One JSON line, then the
card's name and power limit (``nvidia-smi``); each run's details go to
``DIR/startup_time.json`` (``--out``, default the gitignored
``startup_time_out/``).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
FIX = os.path.join(REPO, "fixtures")
GOLD = os.path.join(FIX, "golden")

STEPS = r"""
import time
t = [("interpreter", time.monotonic())]
import json, sys
import numpy
t.append(("import_numpy", time.monotonic()))
import prographmsa_tpu_torch.cli
t.append(("import_cli", time.monotonic()))
import torch
t.append(("import_torch", time.monotonic()))
cuda = DEVICE == "cuda"
if torch.cuda.is_available() != cuda:
    raise SystemExit("torch.cuda.is_available() is not %s" % cuda)
t.append(("cuda_is_available", time.monotonic()))
launches = {}
if cuda:
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    t.append(("cuda_context", time.monotonic()))
    from prographmsa_tpu_torch import _build
    _build.lib()
    t.append(("kernel_library", time.monotonic()))
    launch, run_no = _build.launch, [0]

    def timed(names, fn, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        launch(names, fn, *args)
        torch.cuda.synchronize()
        key = names if isinstance(names, str) else "+".join(names)
        launches.setdefault(key, ([], []))[run_no[0]].append(
            time.perf_counter() - t0)

    _build.launch = timed
from prographmsa_tpu_torch import native
if native.lib() is None:
    raise SystemExit("the native host library did not load")
t.append(("native_library", time.monotonic()))
import contextlib, io, os
from prographmsa_tpu_torch import cli
for run in range(2):
    if cuda:
        run_no[0] = run
    with contextlib.redirect_stderr(io.StringIO()) as err:
        rc = cli.main(["--fasta", "--mldist", "--nwdist", "--device",
                       DEVICE, FASTA, "-o", OUTFILE])
    if rc != 0:
        raise SystemExit("the CLI exited %d: %s" % (rc, err.getvalue()))
    t.append(("cli_run_%d" % (run + 1), time.monotonic()))
print(json.dumps({"marks": t, "launches": launches,
                  "last": time.monotonic()}))
sys.stdout.flush()
"""

BYTECODE = r"""
import importlib.machinery, json, os, sys, time
loader = importlib.machinery.SourceFileLoader
to_code, found = loader.source_to_code, []

def counted(self, data, path, *a, **kw):
    t0 = time.perf_counter()
    try:
        return to_code(self, data, path, *a, **kw)
    finally:
        found.append((path, time.perf_counter() - t0))

loader.source_to_code = counted
import torch
mine = [s for p, s in found if os.sep + "torch" + os.sep in p]
print(json.dumps({"compiled": len(mine), "seconds": sum(mine),
                  "dont_write_bytecode": sys.flags.dont_write_bytecode,
                  "torch_dir_writable": os.access(
                      os.path.dirname(torch.__file__), os.W_OK)}))
"""

CELLS = (("t_fam100", ["--fasta", "-t", GOLD + "/tree0_fam100.nwk",
                       FIX + "/fam100.fasta"], "t_fam100.fasta"),
         ("fam500_i0", ["--fasta", "-i", "0", FIX + "/fam500.fasta"],
          "fam500_i0.fasta"))


def spawn(argv, env=None):
    """(wall seconds from spawn to exit, stdout, stderr, start mark)."""
    t0 = time.monotonic()
    p = subprocess.run(argv, cwd=REPO, capture_output=True, text=True,
                       timeout=900, env=env)
    wall = time.monotonic() - t0
    if p.returncode != 0:
        raise SystemExit("%s exited %d:\n%s" % (argv[:3], p.returncode,
                                                p.stderr[-3000:]))
    return wall, p.stdout, p.stderr, t0


def summary(values):
    return {"median": statistics.median(values), "min": min(values),
            "max": max(values), "n": len(values)}


def steps(runs, device, tmp):
    """{step: [seconds of each run]} and each kernel's launch times."""
    py = sys.executable
    out = {"python_pass": []}
    for _ in range(runs):
        out["python_pass"].append(spawn([py, "-c", "pass"])[0])
    code = (STEPS.replace("DEVICE", repr(device))
            .replace("FASTA", repr(FIX + "/fam20.fasta"))
            .replace("OUTFILE", repr(os.path.join(tmp, "fam20.fasta"))))
    kernels = {}
    for _ in range(runs):
        wall, stdout, _, t0 = spawn([py, "-c", code])
        got = json.loads(stdout.strip().splitlines()[-1])
        prev = t0
        for name, mark in got["marks"]:
            out.setdefault(name + "_s", []).append(mark - prev)
            prev = mark
        out.setdefault("exit_s", []).append(t0 + wall - got["last"])
        out.setdefault("process_s", []).append(wall)
        for key, (first, second) in got["launches"].items():
            k = kernels.setdefault(key, {"first_s": [], "later_s": [],
                                         "first_extra_s": []})
            later = statistics.median(second) if second else None
            k["first_s"].append(first[0])
            if later is not None:
                k["later_s"].append(later)
                k["first_extra_s"].append(first[0] - later)
        with open(os.path.join(tmp, "fam20.fasta")) as f, \
                open(os.path.join(GOLD, "c2_fam20.fasta")) as g:
            if f.read() != g.read():
                raise SystemExit("c2_fam20 differs from its golden")
    return out, kernels


def bytecode():
    return [json.loads(spawn([sys.executable, "-c", BYTECODE])[1]
                       .strip().splitlines()[-1]) for _ in range(2)]


def phases_of(err):
    return {m.group(1): float(m.group(2)) for m in re.finditer(
        r"^  (\S+)\s+([0-9.]+) s  \(", err, re.M)}


def cells(runs, device, tmp):
    """Each cell's runs: wall and --timings phases, under the pool's
    default size and PROGRAPHMSA_THREADS=1."""
    res = {}
    for threads in ("default", "1"):
        env = dict(os.environ)
        if threads == "1":
            env["PROGRAPHMSA_THREADS"] = "1"
        else:
            env.pop("PROGRAPHMSA_THREADS", None)
        for name, args, golden in CELLS:
            out = os.path.join(tmp, name + ".fasta")
            for _ in range(runs):
                wall, _, err, _ = spawn(
                    [sys.executable, "-m", "prographmsa_tpu_torch.cli",
                     *args, "--device", device, "--timings", "-o", out],
                    env)
                with open(out) as f, open(os.path.join(GOLD, golden)) as g:
                    if f.read() != g.read():
                        raise SystemExit("%s differs from its golden" % name)
                res.setdefault("%s/threads_%s" % (name, threads), []).append(
                    {"wall_s": wall, **phases_of(err)})
    return res


def card_line():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except OSError:
        return "no nvidia-smi"


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--cells", action="store_true")
    ap.add_argument("--out", default=os.path.join(REPO, "startup_time_out"))
    args = ap.parse_args()
    if args.device == "cuda":
        from prographmsa_tpu_torch import _build
        _build.build()
    os.makedirs(args.out, exist_ok=True)
    with tempfile.TemporaryDirectory() as tmp:
        byte = bytecode()
        raw, kernels = steps(args.runs, args.device, tmp)
        walls = cells(args.runs, args.device, tmp) if args.cells else {}
    result = {
        "device": args.device,
        "steps": {k: summary(v) for k, v in raw.items()},
        "first_launch": {k: {m: summary(v) for m, v in d.items() if v}
                         for k, d in kernels.items()},
        "torch_bytecode": byte,
        "cells": {k: {p: summary([r[p] for r in v if p in r])
                      for p in sorted({p for r in v for p in r})}
                  for k, v in walls.items()}}
    with open(os.path.join(args.out, "startup_time.json"), "w") as f:
        json.dump({**result, "runs": {"steps": raw, "cells": walls}}, f,
                  indent=1)
    print(json.dumps(result))
    print(card_line())


if __name__ == "__main__":
    main()
