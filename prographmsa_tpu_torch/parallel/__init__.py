"""Scale-out: a level's DP batch and the NW chunks split over a mesh of
shards, within one process and over ``torch.distributed`` processes.

The port of prographmsa_tpu/parallel/.  A mesh (``mesh.Mesh``) is an
ordered list of shards, each a torch device; an entry may repeat, so
``[cuda:0] * 4`` is a 4-shard mesh on one card and ``[cpu] * 8`` the test
mesh.  Across processes (``distributed``) the global mesh is the
processes' local meshes in rank order; every collective runs over ``gloo``
on host tensors.  ``sharded`` holds the split programs S1, S3, S4 and S5,
and ``dryrun`` the multi-shard dry run.  The mesh has no parameters: the
weight conversion (``convert.py``) has nothing to carry for it.
"""

from .mesh import Mesh, make_mesh, pad_to_multiple  # noqa: F401
