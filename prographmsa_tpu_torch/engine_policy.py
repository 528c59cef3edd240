"""Which executor runs the graph-pair DP of a level batch.

``torch``: the port's device batch (align/graph_dp_cuda.py) on the run's
device.  ``native``: the port's C++ host tier (native/), pair by pair.  A
probed ``auto`` policy (the reference's engine_policy.use_pallas_dp with
its calibration) is still to be ported (ROADMAP)."""

from __future__ import annotations

ENGINES = ("torch", "native")


def use_torch_dp(options) -> bool:
    eng = getattr(options, "engine", "torch")
    if eng not in ENGINES:
        raise ValueError("engine %r is not one of %s" % (eng, ENGINES))
    return eng == "torch"
