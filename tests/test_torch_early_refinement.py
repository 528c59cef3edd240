"""The port's early refinement (--early_refinement) in its level scheduler
(prographmsa_tpu_torch/engine/level_driver.py: each level's refinement
pairs in one batch, then each node's incremental merges) against the JAX
package's sequential recursion (its host engine, ``native``) and against
the port's own (``progressive_alignment`` with ``alignment_cache``), node
by node.  The port's batches run on ``device=cpu`` (the DP kernels' plain
PyTorch versions); rep8's stay on the host (``device=None``, see
tests/test_torch_find_root.py).  Exact: equal aligned sequences, graphs,
scores, ``n_tr_indels`` and TR lines.
"""

import pytest

from prographmsa_tpu.engine import progressive as ref_pg

from prographmsa_tpu_torch.engine import early_refinement as er
from prographmsa_tpu_torch.engine import level_driver as ld
from prographmsa_tpu_torch.engine import progressive as pg

from test_torch_find_root import CPU, same_result, setup, stderr_of

CASES = [("fam6", CPU), ("fam20", CPU), ("rep8", None)]


def _batched(name, device):
    spec, seqs, tree, reps, factory, opts = setup(
        "prographmsa_tpu_torch", name, earlyref_flag=True)
    return stderr_of(ld.progressive_alignment_batched, spec, seqs, tree,
                     reps, None, factory, opts, device, "torch")


@pytest.mark.parametrize("name,device", CASES, ids=[c[0] for c in CASES])
def test_level_scheduler_refinement_matches_jax(name, device):
    spec, seqs, tree, reps, factory, opts = setup(
        "prographmsa_tpu", name, earlyref_flag=True)
    ref, ref_err = stderr_of(ref_pg.progressive_alignment, spec, seqs, tree,
                             reps, None, factory, opts, {})
    res, err = _batched(name, device)
    same_result(res, ref)
    assert err == ref_err
    if name == "rep8":
        assert err.count("TR indels at") == len(seqs) - 1


@pytest.mark.parametrize("name,device", CASES[:2], ids=[c[0] for c in
                                                        CASES[:2]])
def test_every_refined_node_equals_the_sequential_recursion(name, device,
                                                            monkeypatch):
    """Each node's refined result, keyed by its leaves: the batched
    refinement (``level_driver.refine``) against the recursion's
    (``early_refinement.refine``), and the number of refined nodes."""
    def recorder(module, sink):
        orig = module.refine

        def wrapped(old_result, *a):
            out = orig(old_result, *a)
            sink[frozenset(old_result.aligned_sequences)] = out
            return out

        monkeypatch.setattr(module, "refine", wrapped)

    seq_nodes, batch_nodes = {}, {}
    recorder(er, seq_nodes)
    recorder(ld, batch_nodes)
    spec, seqs, tree, reps, factory, opts = setup(
        "prographmsa_tpu_torch", name, earlyref_flag=True)
    cache = {}
    seq = pg.progressive_alignment(spec, seqs, tree, reps, None, factory,
                                   opts, cache)
    res, _ = _batched(name, device)
    same_result(res, seq)
    assert len(cache) == 2 * len(seqs) - 1          # every node's result
    # every internal node but those whose children are both leaves
    assert 0 < len(seq_nodes) < len(seqs) - 1
    assert sorted(map(sorted, batch_nodes)) == sorted(map(sorted, seq_nodes))
    for key, r in seq_nodes.items():
        same_result(batch_nodes[key], r)

