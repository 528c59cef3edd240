"""PyTorch/CUDA port of prographmsa_tpu (H100).

The port keeps the JAX package as its reference and imports that package's
host-only layers (io, alphabet, graph, models, tree, distances, merge,
backtrack, native, timings), which hold no JAX.  What it replaces is the
device work of the main CLI path: the per-level graph-pair DP batch, as
hand-written CUDA kernels (``csrc/``) with a plain PyTorch twin beside each
(used for CPU tensors and as the kernel's check).  It never imports JAX.
"""
