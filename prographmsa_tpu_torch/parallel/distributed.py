"""Multi-process scale-out on ``torch.distributed``.

The port of prographmsa_tpu/parallel/distributed.py.  Every process runs
the same program on the same input: it launches its own shards' work (a
share of each level's DP batch, of each NW chunk), fetches each launch's
result to the host, gathers the host rows of every process, and then does
the host work that follows over all pairs, as one process would.  So every
process computes, and writes, the same output.

The process group is ``gloo`` and every collective runs on host tensors:
nothing stays on the card after a launch's fetch, the rows are a few KB a
pair, NCCL refuses two ranks on one card, and gloo does not gather CUDA
tensors.  The group has an explicit timeout, so a process whose peer died
raises instead of waiting for ever.  Collectives are issued from the main
thread only (the level scheduler's, never its host pool), and what decides
that one is issued (the engine's routing, the launch cuts, empty shards)
comes from data that is the same in every process.

Activation is explicit and environment-driven:

  PROGRAPHMSA_DIST=1                    enable
  PROGRAPHMSA_COORD=host0:8476          rendezvous address (tcp://host:port)
  PROGRAPHMSA_NUM_PROCESSES / PROGRAPHMSA_PROCESS_ID
                                        world size and this process's rank

Where the ``PROGRAPHMSA_*`` topology is unset, torchrun's ``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK`` are read instead (the
counterpart of ``jax.distributed`` reading a TPU pod's metadata); with
neither, joining raises.  ``shutdown()`` is registered atexit.

torch is imported by the functions that use it: a run under ``--engine
native`` asks ``is_enabled``, ``world`` and ``rank`` (cli.py,
checkpoint.py) and imports no torch.
"""

from __future__ import annotations

import atexit
import contextlib
import datetime
import os
import sys
import tempfile

import numpy as np

from .mesh import Mesh

TIMEOUT_S = 600           # a collective waits this long for its peers
# What c10d prints to stderr when the reverse lookup of a peer's address
# fails, as it does on a host without DNS: the run is unaffected, and the
# CLI's stderr must stay the single process's.
NOISE = "hostname of the client socket cannot be retrieved"

_initialized = False
_meshes: dict = {}


def is_enabled() -> bool:
    return os.environ.get("PROGRAPHMSA_DIST", "0") == "1"


def active() -> bool:
    """A process group of this module is up."""
    return _initialized


def topology() -> tuple:
    """(tcp address, world size, rank) from the ``PROGRAPHMSA_*`` knobs,
    each falling back to torchrun's names; raises where one is missing."""
    env = os.environ
    coord = env.get("PROGRAPHMSA_COORD")
    if not coord and env.get("MASTER_ADDR") and env.get("MASTER_PORT"):
        coord = "%s:%s" % (env["MASTER_ADDR"], env["MASTER_PORT"])
    world = env.get("PROGRAPHMSA_NUM_PROCESSES") or env.get("WORLD_SIZE")
    rank = env.get("PROGRAPHMSA_PROCESS_ID") or env.get("RANK")
    if not (coord and world and rank):
        raise RuntimeError(
            "PROGRAPHMSA_DIST=1 needs PROGRAPHMSA_COORD (host:port), "
            "PROGRAPHMSA_NUM_PROCESSES and PROGRAPHMSA_PROCESS_ID, or "
            "torchrun's MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK")
    return "tcp://" + coord, int(world), int(rank)


def local_devices(device) -> tuple:
    """This process's shards for a run on ``device``: every visible card
    for CUDA (one process per card: set CUDA_VISIBLE_DEVICES), the CPU
    once otherwise."""
    import torch

    if device is not None and torch.device(device).type == "cuda":
        return tuple(torch.device("cuda", i)
                     for i in range(torch.cuda.device_count()))
    return (torch.device("cpu"),)


def maybe_initialize(device=None) -> bool:
    """Join the process group if PROGRAPHMSA_DIST=1.  Returns whether
    distributed mode is active.  Idempotent; failures are fatal (a job that
    was asked to be distributed must not silently run alone).  Prints one
    line to stderr with the local and global shard counts of a run on
    ``device``."""
    global _initialized
    if not is_enabled():
        return False
    if _initialized:
        return True
    import torch.distributed as dist

    addr, world, rank = topology()
    with _without_noise():
        dist.init_process_group("gloo", init_method=addr, world_size=world,
                                rank=rank,
                                timeout=datetime.timedelta(seconds=TIMEOUT_S))
    _initialized = True
    atexit.register(shutdown)
    mesh = mesh_for(device if device is not None else "cpu")
    print("prographmsa: joined distributed cluster as process %d/%d "
          "(%d local / %d global shards)"
          % (rank, world, len(mesh.devices), mesh.size), file=sys.stderr)
    return True


@contextlib.contextmanager
def _without_noise():
    """Everything written to file descriptor 2 inside the block, written
    to stderr after it less the lines that hold NOISE."""
    sys.stderr.flush()
    saved = os.dup(2)
    with tempfile.TemporaryFile() as tmp:
        os.dup2(tmp.fileno(), 2)
        try:
            yield
        finally:
            os.dup2(saved, 2)
            os.close(saved)
            tmp.seek(0)
            for line in tmp.read().decode(errors="replace").splitlines(True):
                if NOISE not in line:
                    sys.stderr.write(line)
            sys.stderr.flush()


def shutdown() -> None:
    global _initialized
    if not _initialized:
        return
    _initialized = False
    _meshes.clear()
    try:
        import torch.distributed as dist
        dist.destroy_process_group()
    except Exception:  # noqa: BLE001 — atexit must never raise
        pass


def rank() -> int:
    if not _initialized:
        return 0
    import torch.distributed as dist
    return dist.get_rank()


def world() -> int:
    if not _initialized:
        return 1
    import torch.distributed as dist
    return dist.get_world_size()


def all_gather(arr: np.ndarray) -> list:
    """Every process's 1-D int32 or int64 array, in rank order (sizes
    first, then one padded ``all_gather``).  Alone, ``[arr]``."""
    arr = np.ascontiguousarray(arr)
    if arr.ndim != 1 or arr.dtype not in (np.int32, np.int64):
        raise ValueError("all_gather: 1-D int32 or int64, got %s %s"
                         % (arr.dtype, arr.shape))
    if world() == 1:
        return [arr]
    import torch
    import torch.distributed as dist

    n = world()
    sizes = [torch.zeros(1, dtype=torch.int64) for _ in range(n)]
    dist.all_gather(sizes, torch.tensor([arr.size], dtype=torch.int64))
    sizes = [int(s) for s in sizes]
    top = max(max(sizes), 1)
    mine = torch.zeros(top, dtype=torch.from_numpy(arr).dtype)
    mine[:arr.size] = torch.from_numpy(arr)
    out = [torch.empty_like(mine) for _ in range(n)]
    dist.all_gather(out, mine)
    return [t[:s].numpy() for t, s in zip(out, sizes)]


def all_reduce_sum(arr: np.ndarray) -> np.ndarray:
    """The sum over the processes of a float32, float64, int32 or int64
    array; alone, the array."""
    if world() == 1:
        return arr
    import torch
    import torch.distributed as dist

    t = torch.from_numpy(np.ascontiguousarray(arr).copy())
    dist.all_reduce(t)
    return t.numpy()


def broadcast(values) -> list:
    """Process 0's float64 ``values``, in every process."""
    if world() == 1:
        return [float(v) for v in values]
    import torch
    import torch.distributed as dist

    t = torch.tensor([float(v) for v in values], dtype=torch.float64)
    dist.broadcast(t, 0)
    return t.tolist()


def global_mesh(devices) -> Mesh:
    """The global mesh of which ``devices`` are this process's shards: the
    processes' local meshes in rank order (one gather of the counts, a
    collective)."""
    counts = [int(c[0]) for c in all_gather(
        np.array([len(devices)], np.int64))]
    r = rank()
    return Mesh(tuple(devices), rank=r, world=len(counts),
                offset=sum(counts[:r]), size=sum(counts))


def mesh_for(device) -> Mesh:
    """The global mesh of a run on ``device`` (``local_devices``), made
    once per device type (a collective the first time)."""
    import torch

    kind = torch.device(device).type
    if kind not in _meshes:
        _meshes[kind] = global_mesh(local_devices(device))
    return _meshes[kind]
