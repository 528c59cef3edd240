"""Meshes of shards and the split of a batch over them.

The port of prographmsa_tpu/parallel/mesh.py.  One axis, ``pairs``, is
enough: every batch split here (a level's graph pairs, a chunk of NW
pairs) is data parallel, and the model matrices are small and replicated.
A shard is a torch device, and a device may hold several shards.  The split
is a function of the batch size and the global shard count only, so it is
the same in every process.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class Mesh:
    """This process's shards (``devices``) within the global mesh: the
    processes' local meshes in rank order, ``offset`` the global index of
    this process's first shard and ``size`` the shards of all processes."""
    devices: tuple
    rank: int = 0
    world: int = 1
    offset: int = 0
    size: int = 0

    def __post_init__(self):
        import torch

        object.__setattr__(self, "devices",
                           tuple(torch.device(d) for d in self.devices))
        if not self.size:
            object.__setattr__(self, "size", len(self.devices))
        if not 0 <= self.offset <= self.size - len(self.devices):
            raise ValueError("mesh: %d local shards at %d do not fit %d"
                             % (len(self.devices), self.offset, self.size))

    def local(self, parts):
        """(device, part) of each local shard, from the global ``parts``
        that ``split`` or ``deal`` made."""
        return list(zip(self.devices,
                        parts[self.offset:self.offset + len(self.devices)]))


def make_mesh(n_devices: int | None = None, device_type: str = "cuda"
              ) -> Mesh:
    """A 1-D mesh over the first ``n_devices`` visible cards (every card
    when None); ``device_type="cpu"`` gives ``n_devices`` (default 1) CPU
    shards."""
    import torch

    if device_type == "cpu":
        return Mesh((torch.device("cpu"),) * (n_devices or 1))
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n_devices is None:
        n_devices = have
    if have < n_devices or n_devices < 1:
        raise ValueError("need %d devices, have %d" % (n_devices, have))
    return Mesh(tuple(torch.device(device_type, i)
                      for i in range(n_devices)))


def pad_to_multiple(arr: np.ndarray, mult: int, axis: int = 0,
                    fill=0) -> np.ndarray:
    n = arr.shape[axis]
    pad = (-n) % mult
    if pad == 0:
        return arr
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, pad)
    return np.pad(arr, widths, constant_values=fill)


def split(n: int, shards: int) -> list:
    """Indices 0 .. n-1 in ``shards`` contiguous runs, the first n %
    shards of them one longer: each index exactly once, in order."""
    return np.array_split(np.arange(n), shards)


def deal(n: int, shards: int) -> list:
    """Indices 0 .. n-1 dealt round the shards: shard s holds s, s +
    shards, ...; each index exactly once.  Dealt from a size-sorted list,
    each shard takes about an equal share of the work."""
    return [np.arange(s, n, shards) for s in range(shards)]


def fetch_async(tensors):
    """Start copying CUDA tensors into pinned host memory (on the current
    card's stream); CPU tensors are returned as they are."""
    import torch

    if tensors[0].device.type != "cuda":
        return tensors, None
    host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            for t in tensors]
    for h, t in zip(host, tensors):
        h.copy_(t, non_blocking=True)
    ev = torch.cuda.Event()
    ev.record()
    return host, ev


def fetched(out):
    """The numpy arrays of a ``fetch_async``, once the copies are done."""
    host, ev = out
    if ev is not None:
        ev.synchronize()
    return [h.numpy() for h in host]


def on_device(device):
    """A context that makes ``device`` the current card (kernels launch on
    the current card's stream); nothing for the CPU."""
    import torch

    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()
