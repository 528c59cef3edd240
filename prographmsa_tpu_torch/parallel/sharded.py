"""Programs split over a mesh: the port of prographmsa_tpu/parallel/
sharded.py.

Each runs on every local shard's contiguous share of a batch
(``mesh.split``), fetches the shard's result to the host and gathers the
shares of every process (``distributed.all_gather``), so every process
holds the whole result:

* S1 ``sharded_nw_counts``: D2 (distances/nw_cuda.nw_counts) on each
  shard's share of the NW pairs; counts [B, dim, dim] and gaps [B] int32.
  The JAX program's third output (the final W row) has no counterpart in
  D2, and no caller reads it.
* S3 ``sharded_gram``: each shard's row block of the k-mer counts times the
  whole count matrix, a float32 ``torch.matmul`` with TF32 off.
* S4 ``sharded_freq_hist``: the +F residue histogram, a count of the valid
  values per shard, summed over the shards and the processes.
* S5 ``pipeline_step``: S1, S3 and S4 in turn (the JAX package's
  ``make_pipeline_step``), the dry run's step.

None of these has a kernel of its own: S1 runs D2, S3 and S4 are plain
torch operations.  The level batch's split (S2) is in
align/graph_dp_cuda.py.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import full_float32
from . import distributed
from .mesh import fetch_async, fetched, on_device, split

_WIRE = {4: np.int32, 8: np.int64}     # the gather's view of each dtype


def launch_split(mesh, n: int, run) -> list:
    """``run(device, idx)`` (a tuple of tensors) on each local shard's
    share ``idx`` of range(n), shards with no share skipped; each result's
    copy to the host started as it is launched.  Returns what
    ``gather_split`` takes."""
    pending = []
    for dev, idx in mesh.local(split(n, mesh.size)):
        if len(idx):
            with on_device(dev):
                pending.append(fetch_async(run(dev, idx)))
    return pending


def gather_split(pending, outs) -> list:
    """The results of ``launch_split`` over every shard of every process,
    in global order: one array per entry (trailing shape, dtype) of
    ``outs``.  A process with no share still takes part in the gather."""
    local = [fetched(p) for p in pending]
    res = []
    for j, (tail, dtype) in enumerate(outs):
        dtype = np.dtype(dtype)
        wire = _WIRE[dtype.itemsize]
        mine = (np.concatenate([np.ascontiguousarray(f[j]).reshape(-1)
                                for f in local]) if local
                else np.zeros(0, dtype))
        parts = distributed.all_gather(mine.view(wire))
        res.append(np.concatenate(parts).view(dtype).reshape((-1,) + tail))
    return res


def sharded_nw_counts(mesh, s1b, s2b, l1, l2, scoring, go: int, ge: int,
                      dim: int):
    """All-pairs NW fill and backtrack (D2) over the mesh: host arrays in,
    counts [B, dim, dim] and gaps [B] int32 numpy out, as ``nw_counts``
    gives them for the whole batch."""
    from ..distances.nw_cuda import nw_counts

    scoring = np.asarray(scoring, np.int32)
    score_range = (int(scoring.min()), int(scoring.max()))
    s1b, s2b, l1, l2 = (np.asarray(a) for a in (s1b, s2b, l1, l2))

    def run(dev, idx):
        a1, a2, n1, n2, sc = (torch.from_numpy(np.ascontiguousarray(a)).to(
            dev) for a in (s1b[idx], s2b[idx], l1[idx], l2[idx], scoring))
        return nw_counts(a1, a2, n1, n2, sc, go, ge, dim,
                         score_range=score_range)

    return tuple(gather_split(launch_split(mesh, len(s1b), run),
                              (((dim, dim), np.int32), ((), np.int32))))


def sharded_gram(mesh, counts_f32):
    """The k-mer Gram matrix counts @ counts.T, rows split over the mesh:
    each shard multiplies its row block by the whole matrix in float32
    (TF32 off).  Returns [N, N] float32 numpy."""
    c = np.ascontiguousarray(counts_f32, np.float32)
    full_float32()

    def run(dev, idx):
        whole = torch.from_numpy(c).to(dev)
        return (torch.matmul(whole[torch.as_tensor(idx, device=dev)],
                             whole.T),)

    n = len(c)
    return gather_split(launch_split(mesh, n, run),
                        (((n,), np.float32),))[0]


def sharded_freq_hist(mesh, values, dim: int):
    """The +F residue histogram: ``values`` [B, L] int32 (invalid < 0 or
    >= dim) counted per shard over its rows, summed over the shards and the
    processes.  Returns [dim] float32 numpy."""
    v = np.ascontiguousarray(values, np.int32)

    def run(dev, idx):
        rows = torch.from_numpy(v[idx]).to(dev)
        ok = rows[(rows >= 0) & (rows < dim)].long()
        return (torch.bincount(ok, minlength=dim),)

    total = np.zeros(dim, np.int64)
    for (count,) in map(fetched, launch_split(mesh, len(v), run)):
        total += count
    return distributed.all_reduce_sum(total).astype(np.float32)


def pipeline_step(mesh, s1b, s2b, l1, l2, scoring, go: int, ge: int,
                  dim: int, kmer_counts, values):
    """S1, S3 and S4 over the mesh in turn: (counts, gaps, gram, hist)."""
    counts, gaps = sharded_nw_counts(mesh, s1b, s2b, l1, l2, scoring, go, ge,
                                     dim)
    return (counts, gaps, sharded_gram(mesh, kmer_counts),
            sharded_freq_hist(mesh, values, dim))
