"""The port's ``--checkpoint_dir`` resume (prographmsa_tpu_torch/
checkpoint.py and cli.do_align) on ``--device cpu``, the kernels' plain
versions: the JAX package's three cases (tests/test_checkpoint.py) against
the port, a directory that holds a state of the JAX package (read by
neither package's counterpart, the port run with the JAX package refused
by the import system), a forged state, a state of another engine, and a
run interrupted inside an iteration.  The two-process case is in
test_torch_distributed.py.
"""

import os
import pickle

import pytest
import torch

import prographmsa_tpu.cli as jax_cli
from prographmsa_tpu.config import Options as JaxOptions
from prographmsa_tpu.io.fasta import read_fasta as jax_read_fasta
from prographmsa_tpu.tree.phytree import PhyTree as JaxPhyTree
from prographmsa_tpu_torch import checkpoint
from prographmsa_tpu_torch import cli
from prographmsa_tpu_torch.config import Options
from prographmsa_tpu_torch.engine import level_driver
from prographmsa_tpu_torch.io.fasta import read_fasta
from prographmsa_tpu_torch.tree import treenj

from test_e2e_differential import FIX, G, _strip_header
from test_torch_standalone import _check, _run_blocked

CPU = torch.device("cpu")
FAM6 = FIX + "/fam6.fasta"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The plain versions run thousands of small torch ops, which torch's
    intra-op thread pool slows down many times over when parallel test
    workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _align(opts, engine="torch"):
    seqs, _ = read_fasta(opts.sequence_file)
    aligned, trees = cli.do_align(seqs, opts, CPU, engine)
    return aligned, [t.format_newick() for t in trees]


def _count_tree_nj(monkeypatch):
    calls = {"n": 0}
    orig = treenj.tree_nj

    def counting(*a, **kw):
        calls["n"] += 1
        return orig(*a, **kw)

    monkeypatch.setattr(treenj, "tree_nj", counting)
    monkeypatch.setattr(cli, "tree_nj", counting)
    return calls


def _main(args, out):
    assert cli.main(args + ["--device", "cpu", "-o", out]) == 0


def _golden(path, golden):
    with open(path) as f, open(os.path.join(G, golden)) as g:
        return _strip_header(f.read()) == _strip_header(g.read())


def test_resume_skips_tree_phases_and_is_identical(tmp_path, monkeypatch):
    """Resumed (no tree_nj call) = first run = no checkpoint = the JAX
    package's own resumed run with the same Options, whose state sits in
    the same directory under its own name."""
    ck = str(tmp_path / "ck")
    kw = dict(sequence_file=FAM6, fasta_flag=True, checkpoint_dir=ck)
    base = Options(**kw)

    calls = _count_tree_nj(monkeypatch)
    aligned1, trees1 = _align(base)
    assert calls["n"] == 3           # initial + 2 iterations

    jax_opts = JaxOptions(engine="native", **kw)
    assert repr(jax_opts) == repr(base)
    jseqs, _ = jax_read_fasta(FAM6)
    jax_cli.do_align(jseqs, jax_opts)
    jax_aligned, jax_trees = jax_cli.do_align(jseqs, jax_opts)   # resumed
    assert sorted(os.listdir(ck)) == sorted([checkpoint.STATE_FILE,
                                             "phase_state.pkl"])

    calls["n"] = 0
    aligned2, trees2 = _align(base)
    assert calls["n"] == 0           # every tree phase resumed from disk
    assert aligned1 == aligned2 and trees1 == trees2

    aligned3, trees3 = _align(base.replace(checkpoint_dir=""))
    assert aligned1 == aligned3 and trees1 == trees3
    assert aligned2 == jax_aligned
    assert trees2 == [t.format_newick() for t in jax_trees]


def test_stale_checkpoint_is_ignored(tmp_path, monkeypatch):
    a = Options(sequence_file=FAM6, fasta_flag=True,
                checkpoint_dir=str(tmp_path / "ck"))
    _align(a)

    # different alignment-relevant options -> fingerprint mismatch
    b = a.replace(mldist_flag=True)
    calls = _count_tree_nj(monkeypatch)
    out_b, trees_b = _align(b)
    assert calls["n"] == 3           # recomputed, stale state not trusted

    # and the new state belongs to b now: rerunning b resumes
    calls["n"] = 0
    assert _align(b) == (out_b, trees_b)
    assert calls["n"] == 0


def test_checkpoint_with_fixed_tree(tmp_path):
    """-t implies iters=0: the state holds only the parsed tree; resume
    gives the golden again."""
    args = ["--fasta", "-t", G + "/tree0_fam6.nwk", "--checkpoint_dir",
            str(tmp_path / "ck"), FAM6]
    for run in ("first", "resumed"):
        out = str(tmp_path / run)
        _main(args, out)
        assert _golden(out, "t_fam6.fasta"), run


def test_a_jax_package_state_is_neither_read_nor_imported(tmp_path):
    """The JAX package's CLI writes its state into D; the port's CLI on D,
    with the JAX package refused by the import system, is golden, imports
    nothing of it, writes its own state and leaves the JAX one as it was."""
    ck = str(tmp_path / "ck")
    jax_out = str(tmp_path / "jax.fasta")
    assert jax_cli.main(["--engine", "native", "--fasta", "--checkpoint_dir",
                         ck, FAM6, "-o", jax_out]) == 0
    assert _golden(jax_out, "c1_fam6.fasta")
    jax_state = os.path.join(ck, "phase_state.pkl")
    with open(jax_state, "rb") as f:
        before = f.read()
    stamp = os.stat(jax_state).st_mtime_ns

    out = str(tmp_path / "port.fasta")
    stderr = _run_blocked(["--engine", "native", "--fasta",
                           "--checkpoint_dir", ck, FAM6], out)
    assert stderr.endswith("NATIVE-LOADED\n"), stderr[-2000:]
    _check("c1_fam6.fasta", out, stderr[:-len("NATIVE-LOADED\n")])
    with open(jax_state, "rb") as f:
        assert f.read() == before
    assert os.stat(jax_state).st_mtime_ns == stamp
    assert os.path.exists(os.path.join(ck, checkpoint.STATE_FILE))


class _Shell:
    """Unpickled, runs a shell command."""

    def __init__(self, cmd):
        self.cmd = cmd

    def __reduce__(self):
        return os.system, (self.cmd,)


def _forged_tree(kind, marker):
    if kind == "jax_tree":
        return JaxPhyTree("a")
    if kind == "os_system":
        return _Shell("touch " + marker)
    return "((a,b),c);"               # admitted types, but not a tree


@pytest.mark.parametrize("kind", ["jax_tree", "os_system", "not_a_tree"])
def test_a_forged_state_is_recomputed(kind, tmp_path, monkeypatch):
    """A state under the port's name with the right key and format whose
    tree is a class outside the port, a call, or no tree at all: ignored,
    every tree phase recomputed, golden output, then a state of the port's
    own again."""
    ck = str(tmp_path / "ck")
    args = ["--fasta", "--checkpoint_dir", ck, FAM6]
    _main(args, str(tmp_path / "first"))
    path = os.path.join(ck, checkpoint.STATE_FILE)
    with open(path, "rb") as f:
        real = pickle.load(f)
    marker = str(tmp_path / "ran")
    forged = dict(real, tree=_forged_tree(kind, marker), i_next=2)
    with open(path, "wb") as f:
        pickle.dump(forged, f, protocol=pickle.HIGHEST_PROTOCOL)

    calls = _count_tree_nj(monkeypatch)
    out = str(tmp_path / "out")
    _main(args, out)
    assert calls["n"] == 3
    assert _golden(out, "c1_fam6.fasta")
    assert not os.path.exists(marker)
    with open(path, "rb") as f:
        again = checkpoint._PortUnpickler(f).load()
    assert again["key"] == real["key"]
    assert again["tree"].format_newick() == real["tree"].format_newick()


def test_resume_keys_on_the_engine(tmp_path):
    """fam500 -T -i 0: --engine device (the float32 angle Gram) gives
    another guide tree than --engine native; on one directory each engine
    prints its own fresh run's tree, never the other's state."""
    ck = str(tmp_path / "ck")
    base = ["-T", "-i", "0", FIX + "/fam500.fasta"]

    def tree(engine, name, ckpt=True):
        out = str(tmp_path / name)
        _main(base + ["--engine", engine]
              + (["--checkpoint_dir", ck] if ckpt else []), out)
        with open(out) as f:
            return f.read()

    device_fresh = tree("device", "device_fresh")      # ck is empty
    native_fresh = tree("native", "native_fresh", ckpt=False)
    assert device_fresh != native_fresh
    assert tree("native", "native_ck") == native_fresh
    assert tree("device", "device_ck") == device_fresh


class _Interrupted(Exception):
    pass


def test_an_interrupted_run_resumes(tmp_path, monkeypatch):
    """c2_fam20's flags, the progressive pass raising on its second call
    (iteration 1): the run on the same directory is golden and makes
    exactly 2 calls of tree_nj fewer than a fresh run (the initial tree and
    iteration 0's re-tree come from the state)."""
    args = ["--fasta", "--mldist", "--nwdist", FIX + "/fam20.fasta"]
    calls = _count_tree_nj(monkeypatch)
    _main(args, str(tmp_path / "fresh"))
    fresh = calls["n"]
    assert _golden(str(tmp_path / "fresh"), "c2_fam20.fasta")

    ck = str(tmp_path / "ck")
    orig = level_driver.progressive_alignment_batched
    passes = {"n": 0}

    def interrupted(*a, **kw):
        passes["n"] += 1
        if passes["n"] == 2:
            raise _Interrupted
        return orig(*a, **kw)

    monkeypatch.setattr(level_driver, "progressive_alignment_batched",
                        interrupted)
    opts = cli.options_from_args(cli.build_parser().parse_args(
        args + ["--checkpoint_dir", ck])).replace(engine="native")
    seqs, _ = read_fasta(opts.sequence_file)
    with pytest.raises(_Interrupted):
        cli.do_align(seqs, opts, CPU, "torch")
    with open(os.path.join(ck, checkpoint.STATE_FILE), "rb") as f:
        assert checkpoint._PortUnpickler(f).load()["i_next"] == 1
    monkeypatch.setattr(level_driver, "progressive_alignment_batched", orig)

    calls["n"] = 0
    out = str(tmp_path / "resumed")
    _main(args + ["--checkpoint_dir", ck], out)
    assert calls["n"] == fresh - 2
    assert _golden(out, "c2_fam20.fasta")
