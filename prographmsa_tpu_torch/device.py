"""The explicit torch device of a run: ``--device cuda`` (the default) or
``cpu``.  There is no silent CPU run: asking for CUDA on a machine without
it raises."""

from __future__ import annotations

import torch


def resolve_device(name: str) -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device %r requested but torch.cuda."
                               "is_available() is false" % name)
    elif dev.type != "cpu":
        raise ValueError("unsupported device %r (cuda or cpu)" % name)
    return dev


def on_cuda(*tensors) -> bool:
    """True when every tensor lies on a CUDA device, False when every one
    lies on the CPU; mixed or other placements raise."""
    types = {t.device.type for t in tensors}
    if types == {"cuda"}:
        return True
    if types == {"cpu"}:
        return False
    raise ValueError("tensors on mixed or unsupported devices: %s"
                     % sorted(types))


def full_float32() -> None:
    """Set, and assert, that float32 products on the card round in full
    float32: TF32 off for matrix products and convolutions, matmul
    precision "highest"."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError("float32 products on the card are not in full "
                           "float32")
