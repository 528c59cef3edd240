"""The port's scale-out (prographmsa_tpu_torch/parallel/) against the JAX
package's (prographmsa_tpu/parallel/) on the CPU: meshes of CPU shards in
the port, the 8-virtual-device CPU mesh of tests/conftest.py in the JAX
package (its Pallas batch in interpret mode).  Every comparison is exact:
integer counts, float32 products of integers below 2^24, and mappings,
float32 score and n_tr_indels of the DP batch.
"""

import os

import jax
import numpy as np
import pytest
import torch

from prographmsa_tpu.align import graph_dp_pallas as ref_gdp
from prographmsa_tpu.parallel import mesh as ref_mesh
from prographmsa_tpu.parallel import sharded as ref_sharded

from prographmsa_tpu_torch import checks, cli, engine_policy
from prographmsa_tpu_torch.align import graph_dp_cuda as gdp
from prographmsa_tpu_torch.distances.align import GAP_PARAMS, _load_scoring
from prographmsa_tpu_torch.distances.nw_cuda import nw_counts
from prographmsa_tpu_torch.parallel import dryrun, sharded
from prographmsa_tpu_torch.parallel.mesh import (Mesh, deal, make_mesh,
                                                 pad_to_multiple, split)

from test_e2e_differential import FIX, G, _strip_header

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The plain versions run thousands of small torch ops, which torch's
    intra-op thread pool slows down many times over when parallel test
    workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cpu_mesh(k):
    return Mesh((CPU,) * k)


@pytest.fixture(scope="module")
def jax_mesh():
    if len(jax.devices()) < 8:
        pytest.skip("the JAX side needs the 8 virtual CPU devices")
    return ref_mesh.make_mesh(8)


def test_make_mesh_raises_when_short():
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match="need %d devices" % (have + 1)):
        make_mesh(have + 1)
    with pytest.raises(ValueError):
        ref_mesh.make_mesh(len(jax.devices()) + 1)
    assert make_mesh(3, "cpu").devices == (CPU,) * 3
    with pytest.raises(ValueError):
        Mesh((CPU,) * 2, rank=1, world=2, offset=3, size=4)


@pytest.mark.parametrize("shape,mult,axis,fill", [
    ((5, 2), 8, 0, 0), ((8, 2), 8, 0, 0), ((3, 7), 4, 1, -1), ((13,), 8, 0, 5),
    ((0, 3), 4, 0, 0)])
def test_pad_to_multiple_equals_jax(shape, mult, axis, fill):
    a = np.arange(int(np.prod(shape)), dtype=np.int32).reshape(shape)
    ours = pad_to_multiple(a, mult, axis, fill)
    ref = ref_mesh.pad_to_multiple(a, mult, axis, fill)
    assert ours.dtype == ref.dtype and np.array_equal(ours, ref)
    assert (ours is a) == (ref is a)


@pytest.mark.parametrize("n,shards", [(0, 3), (2, 4), (13, 8), (16, 8),
                                      (997, 4), (124750, 7)])
def test_split_covers_each_index_once(n, shards):
    for parts in (split(n, shards), deal(n, shards)):
        assert len(parts) == shards
        assert np.array_equal(np.sort(np.concatenate(parts)), np.arange(n))
    runs = split(n, shards)
    assert np.array_equal(np.concatenate(runs), np.arange(n))
    assert max(map(len, runs)) - min(map(len, runs)) <= 1
    m = Mesh((CPU,) * 2, rank=1, world=3, offset=2, size=shards + 2)
    assert [len(p) for _, p in m.local(split(n, m.size))] == \
        [len(p) for p in split(n, m.size)[2:4]]


def _nw_inputs(B, L, seed=1):
    rng = np.random.default_rng(seed)
    s1 = rng.integers(0, 20, (B, L)).astype(np.int32)
    s2 = rng.integers(0, 20, (B, L)).astype(np.int32)
    l1 = rng.integers(L // 2, L + 1, B).astype(np.int32)
    l2 = rng.integers(L // 2, L + 1, B).astype(np.int32)
    return s1, s2, l1, l2


@pytest.mark.parametrize("B", [16, 13])
def test_sharded_nw_counts_equals_jax(B, jax_mesh):
    """S1 on [cpu] * 8 against the JAX program on the 8-device mesh (B
    padded to a multiple of 8 there, as its caller pads) and against D2's
    plain version unsplit."""
    L = 24
    s1, s2, l1, l2 = _nw_inputs(B, L)
    scoring = _load_scoring("aa")
    go, ge = GAP_PARAMS["aa"]
    counts, gaps = sharded.sharded_nw_counts(cpu_mesh(8), s1, s2, l1, l2,
                                             scoring, go, ge, 20)
    pad = lambda a: pad_to_multiple(a, 8)
    rc, rg, _ = ref_sharded.sharded_nw_counts(
        jax_mesh, pad(s1), pad(s2), pad(l1), pad(l2), scoring, go, ge, 20)
    assert counts.dtype == np.int32 and counts.shape == (B, 20, 20)
    assert np.array_equal(counts, np.asarray(rc)[:B])
    assert np.array_equal(gaps, np.asarray(rg)[:B])
    t = torch.from_numpy
    c0, g0 = nw_counts(t(s1), t(s2), t(l1), t(l2), t(scoring), go, ge, 20)
    assert np.array_equal(counts, c0.numpy())
    assert np.array_equal(gaps, g0.numpy())


def test_sharded_nw_counts_fewer_pairs_than_shards():
    s1, s2, l1, l2 = _nw_inputs(3, 10, seed=4)
    scoring = _load_scoring("aa")
    go, ge = GAP_PARAMS["aa"]
    counts, gaps = sharded.sharded_nw_counts(cpu_mesh(8), s1, s2, l1, l2,
                                             scoring, go, ge, 20)
    t = torch.from_numpy
    c0, g0 = nw_counts(t(s1), t(s2), t(l1), t(l2), t(scoring), go, ge, 20)
    assert np.array_equal(counts, c0.numpy())
    assert np.array_equal(gaps, g0.numpy())


def test_sharded_gram_equals_jax(jax_mesh):
    rng = np.random.default_rng(2)
    c = rng.integers(0, 5, (16, 32)).astype(np.float32)
    ours = sharded.sharded_gram(cpu_mesh(8), c)
    ref = np.asarray(ref_sharded.sharded_gram(jax_mesh, c))
    assert ours.dtype == np.float32
    assert np.array_equal(ours, ref)
    assert np.array_equal(ours, c @ c.T)
    assert np.array_equal(sharded.sharded_gram(cpu_mesh(3), c[:5]),
                          c[:5] @ c[:5].T)


def test_sharded_freq_hist_equals_jax(jax_mesh):
    rng = np.random.default_rng(3)
    v = rng.integers(-1, 22, (16, 40)).astype(np.int32)
    ours = sharded.sharded_freq_hist(cpu_mesh(8), v, 20)
    ref = np.asarray(ref_sharded.sharded_freq_hist(jax_mesh, v, 20))
    assert ours.dtype == np.float32
    assert np.array_equal(ours, ref)
    assert np.array_equal(sharded.sharded_freq_hist(cpu_mesh(5), v[:3], 20),
                          np.bincount(v[:3][(v[:3] >= 0) & (v[:3] < 20)],
                                      minlength=20).astype(np.float32))


def _mesh_batch():
    """tests/test_pallas_mesh.py's batch: ten random chains and a cleaned
    merged graph against a chain."""
    rng = np.random.RandomState(3)
    m = checks.model(0.4)
    pairs = []
    for _ in range(10):
        s1 = "".join(rng.choice(checks.AAS, rng.randint(10, 60)))
        s2 = "".join(rng.choice(checks.AAS, rng.randint(10, 60)))
        pairs.append((checks.chain(s1), checks.chain(s2), m))
    pairs.append((checks.merged("ACDEFGHIKLMNPQRSTVWY", "ACDEFGIKMNPQRSTVWY",
                                m), checks.chain("ACDEFGHIKLMNPQRSTVW"), m))
    return checks.items_and_expected(pairs)


@pytest.fixture(scope="module")
def mesh_batch(jax_mesh):
    items, expected = _mesh_batch()
    ref = ref_gdp.align_pairs_device(items, interpret=True, mesh=jax_mesh)
    return items, expected, ref, gdp.align_pairs_device(items, CPU)


def _same(a, b):
    return (a is not None and b is not None and list(a[0]) == list(b[0])
            and list(a[1]) == list(b[1])
            and np.float32(a[2]) == np.float32(b[2]) and a[3] == b[3])


@pytest.mark.parametrize("k", [1, 3, 4])
def test_align_pairs_device_over_mesh(k, mesh_batch):
    """The level batch split over k CPU shards equals the JAX batch over
    its 8-device mesh, the port's unsplit batch and the host, with the
    same fallback counters as unsplit."""
    items, expected, ref, unsplit = mesh_batch
    before = gdp.fallback_stats()
    ours = gdp.align_pairs_device(items, CPU, cpu_mesh(k))
    after = gdp.fallback_stats()
    assert after["pairs_total"] - before["pairs_total"] == len(items)
    assert after["pairs_device"] - before["pairs_device"] == len(items)
    for o, r, u, aln in zip(ours, ref, unsplit, expected):
        assert _same(o, r) and _same(o, u)
        assert checks.same_alignment(o, aln)


def test_align_pairs_device_fewer_pairs_than_shards():
    m = checks.model(0.3)
    items, expected = checks.items_and_expected(
        [(checks.chain("ACDEFGHIKLMNP"), checks.chain("ACDEFGIKLMNP"), m),
         (checks.chain("MNPQRSTV"), checks.chain("MNPQRSTVWY"), m)])
    res = gdp.align_pairs_device(items, CPU, cpu_mesh(5))
    assert all(checks.same_alignment(r, a) for r, a in zip(res, expected))
    assert gdp.align_pairs_device([], CPU, cpu_mesh(3)) == []


def test_dryrun_on_cpu_mesh():
    dryrun.dryrun(cpu_mesh(4))


def test_level_mesh_is_none_on_one_device():
    """Outside a process group, a run on the host or on one card takes the
    unsplit path."""
    assert engine_policy.level_mesh(None) is None
    assert engine_policy.level_mesh(CPU) is None


@pytest.mark.parametrize("golden,args", [
    ("rr_fam6.fasta", ["--fasta", "-r", "-r", FIX + "/fam6.fasta"]),
    ("t_fam6_er.fasta", ["--fasta", "--early_refinement", "-t",
                         G + "/tree0_fam6.nwk", FIX + "/fam6.fasta"]),
    ("c2_fam20.fasta", ["--fasta", "--mldist", "--nwdist",
                        FIX + "/fam20.fasta"])],
    ids=["rr_fam6", "t_fam6_er", "c2_fam20"])
def test_cli_over_mesh_golden(golden, args, tmp_path, monkeypatch, capsys):
    """The port's CLI with its level mesh set to three CPU shards: the
    root search's waves, the refinement batches, the levels and the NW
    chunks split, the output byte for byte the golden's, stderr too."""
    monkeypatch.setattr(engine_policy, "level_mesh", lambda d: cpu_mesh(3))
    out = str(tmp_path / "out")
    assert cli.main(args + ["--device", "cpu", "-o", out]) == 0
    with open(out) as f, open(os.path.join(G, golden)) as g:
        assert _strip_header(f.read()) == _strip_header(g.read())
    err_golden = os.path.join(G, os.path.splitext(golden)[0] + ".stderr")
    if os.path.exists(err_golden):
        with open(err_golden) as f:
            assert capsys.readouterr().err == f.read()
