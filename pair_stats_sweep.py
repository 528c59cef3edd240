"""Kernel D1 (csrc/pair_stats.cu) against the alternatives its design
turned down, on one card: each alternative is this tree's port with one
edit to the kernel's source or to its block size, built in a copy, held
against its own plain version and timed by pair_stats_time.py on the
c2_fam100 golden, the fam500 ``-i 0`` alignment (made by the port's
``--engine native``) and two synthetic alignments.

    python3 pair_stats_sweep.py

Variants: ``as_is``; ``loads4_bits4`` (a lane's words loaded four at a
time, the counted columns' bytes four at a time); ``loads4_chunk_walk``
(the same, the four words' counted columns walked as one run);
``hist16`` (the histogram zeroed and written 16 bytes at a time);
``warps4``, ``warps2`` (pairs a block).  Runs in turns (as_is first and
last, the others forwards then backwards) and prints one JSON line per
run (device ms per alignment, and the registers of the pair kernels where
that run built them), then the card's name and power limit.  Copies go
to a temporary directory in the output directory (chip_smoke.OUT).
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np

from chip_smoke import GOLD, FIX, OUT, REPO, msa_stats_inputs
from prographmsa_tpu_torch import checks

KERNEL = "prographmsa_tpu_torch/csrc/pair_stats.cu"
WRAPPER = "prographmsa_tpu_torch/distances/prealigned_cuda.py"

WORD_LOOP = """  for (int q = q0; q < q1; ++q) {
    const unsigned gi = Gi[q], gj = Gj[q];
    const unsigned t = gi & gj, x = gi & ~gj, y = gj & ~gi;
    cx = side_opens(x, t, cx, opens);
    cy = side_opens(y, t, cy, opens);
    const unsigned nt = ~t, low = nt & (0u - nt);
    if (!seen) {
      fx = x & low;
      fy = y & low;
      seen = nt != 0;
    }
    for (unsigned m = Ki[q] & Kj[q]; m; m &= m - 1) {
      const int c = q * 32 + __ffs(m) - 1;
      atomicAdd(&hist[Ci[c] * cb + Cj[c]], 1);
    }
  }
"""
CHUNK_HEAD = """  for (int q = q0; q < q1; q += 4) {
    unsigned gi[4], gj[4], mk[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const bool in = q + u < q1;
      gi[u] = in ? Gi[q + u] : ~0u;
      gj[u] = in ? Gj[q + u] : ~0u;
      mk[u] = in ? Ki[q + u] & Kj[q + u] : 0u;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const unsigned t = gi[u] & gj[u], x = gi[u] & ~gj[u],
                     y = gj[u] & ~gi[u];
      cx = side_opens(x, t, cx, opens);
      cy = side_opens(y, t, cy, opens);
      const unsigned nt = ~t, low = nt & (0u - nt);
      if (!seen) {
        fx = x & low;
        fy = y & low;
        seen = nt != 0;
      }
    }
"""
BATCH = """      int c[4], a[4], b[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        %s
        c[u] = m ? base + __ffs(m) - 1 : -1;
        m &= m - 1;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (c[u] >= 0) {
          a[u] = Ci[c[u]];
          b[u] = Cj[c[u]];
        }
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (c[u] >= 0) atomicAdd(&hist[a[u] * cb + b[u]], 1);
"""
LOADS4_BITS4 = CHUNK_HEAD + """#pragma unroll
    for (int w4 = 0; w4 < 4; ++w4) {
      unsigned m = mk[w4];
      const int base = (q + w4) * 32;
      while (m) {
""" + BATCH % "" + """      }
    }
  }
"""
# the four words shift down as they empty; m names the lowest
LOADS4_CHUNK_WALK = CHUNK_HEAD + """    int base = q * 32;
    while (mk[0] | mk[1] | mk[2] | mk[3]) {
      unsigned& m = mk[0];
""" + BATCH % """#pragma unroll
        for (int s = 0; s < 3; ++s)
          if (mk[0] == 0u) {
            mk[0] = mk[1];
            mk[1] = mk[2];
            mk[2] = mk[3];
            mk[3] = 0u;
            base += 32;
          }""" + """    }
  }
"""
HIST16 = [
    ("""  int* hist = hist_all + w * cb * cb;
  for (int k = lane; k < cb * cb; k += 32) hist[k] = 0;
""", """  const int n = cb * cb, n4 = (n & 3) ? 0 : n >> 2;
  int* hist = hist_all + w * n;
  int4* hist4 = (int4*)hist;
  for (int k = lane; k < n4; k += 32) hist4[k] = make_int4(0, 0, 0, 0);
  for (int k = 4 * n4 + lane; k < n; k += 32) hist[k] = 0;
"""),
    ("""  for (int k = lane; k < cb * cb; k += 32) out[k] = (OutT)hist[k];
""", """  for (int k = lane; k < n4; k += 32) {
    const int4 v = hist4[k];
    if (sizeof(OutT) == 2)
      *(uint2*)(out + 4 * k) = make_uint2(
          ((unsigned)v.x & 0xffffu) | ((unsigned)v.y << 16),
          ((unsigned)v.z & 0xffffu) | ((unsigned)v.w << 16));
    else
      *(int4*)(out + 4 * k) = v;
  }
  for (int k = 4 * n4 + lane; k < n; k += 32) out[k] = (OutT)hist[k];
"""),
    ("extern __shared__ int hist_all[];",
     "extern __shared__ __align__(16) int hist_all[];")]

VARIANTS = {
    "as_is": [],
    "loads4_bits4": [(KERNEL, WORD_LOOP, LOADS4_BITS4)],
    "loads4_chunk_walk": [(KERNEL, WORD_LOOP, LOADS4_CHUNK_WALK)],
    "hist16": [(KERNEL, a, b) for a, b in HIST16],
    "warps4": [(WRAPPER, "\nWARPS = 8 ", "\nWARPS = 4 ")],
    "warps2": [(WRAPPER, "\nWARPS = 8 ", "\nWARPS = 2 ")],
}


def make_tree(root, name, edits):
    tree = os.path.join(root, name)
    shutil.copytree(os.path.join(REPO, "prographmsa_tpu_torch"),
                    os.path.join(tree, "prographmsa_tpu_torch"),
                    ignore=shutil.ignore_patterns(".build", "__pycache__"))
    for path, old, new in edits:
        f = os.path.join(tree, path)
        with open(f) as fh:
            src = fh.read()
        if src.count(old) != 1:
            raise SystemExit("pair_stats_sweep: %s: the edit's anchor is not "
                             "in %s once" % (name, path))
        with open(f, "w") as fh:
            fh.write(src.replace(old, new))
    return tree


def main():
    os.makedirs(OUT, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=OUT) as tmp:
        l500 = os.path.join(tmp, "l500.fasta")
        subprocess.run([sys.executable, "-m", "prographmsa_tpu_torch.cli",
                        "--fasta", "-i", "0", FIX + "/fam500.fasta",
                        "--engine", "native", "-o", l500], check=True,
                       cwd=REPO, capture_output=True, timeout=600)
        inputs = {"c2_fam100": (*msa_stats_inputs(GOLD + "/c2_fam100.fasta"),
                                20),
                  "fam500_i0": (*msa_stats_inputs(l500), 20)}
        for alpha, mask in (("codon", "transparent_lanes"),
                            ("dna", "x_residues")):
            vals, gapm, cb = checks.pair_stats_msa(alpha, mask)
            pi, pj = (a.astype(np.int32)
                      for a in np.triu_indices(len(vals), 1))
            inputs[alpha + "_" + mask] = (vals, gapm, pi, pj, cb)
        files = []
        for name, (vals, gapm, pi, pj, cb) in inputs.items():
            f = os.path.join(tmp, name + ".npz")
            np.savez(f, vals=vals, gapm=gapm, pi=pi, pj=pj, cb=cb)
            files.append("%s=%s" % (name, f))
        trees = {name: make_tree(tmp, name, edits)
                 for name, edits in VARIANTS.items()}
        others = [n for n in VARIANTS if n != "as_is"]
        for name in ["as_is"] + others + others[::-1] + ["as_is"]:
            out = subprocess.run(
                [sys.executable, os.path.join(REPO, "pair_stats_time.py"),
                 "--check", trees[name], *files], capture_output=True,
                text=True, timeout=900)
            if out.returncode != 0:
                raise SystemExit("pair_stats_sweep: %s failed:\n%s"
                                 % (name, out.stderr[-3000:]))
            ms = json.loads(out.stdout.strip().splitlines()[-1])
            print(json.dumps({"variant": name,
                              "registers": ms.pop("registers"),
                              "device_ms": ms}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())


if __name__ == "__main__":
    main()
