"""The port's CLI (python -m prographmsa_tpu_torch.cli) and its dist tool
(python -m prographmsa_tpu_torch.dist_cli) against the goldens, byte for
byte, with the card's stages (DP batch, NW, prealigned statistics) on
``--device cpu`` (the kernels' plain PyTorch versions).  The rest of the
golden corpus is in test_torch_cli_corpus*.py and test_torch_cli_reroot.py.
On the card chip_smoke.py drives the same CLI with ``--device cuda`` on
the corpus, fam100 and fam500.
"""

import os
import subprocess
import sys

import pytest
import torch

from test_e2e_differential import (DIST_CASES, FIX, G, REPO, _strip_header,
                                   run_cli)

CASES = [
    ("t_fam6.fasta", ["--fasta", "-t", G + "/tree0_fam6.nwk",
                      FIX + "/fam6.fasta"]),
    ("t_fam20.fasta", ["--fasta", "-t", G + "/tree0_fam20.nwk",
                       FIX + "/fam20.fasta"]),
    ("c1_fam20.fasta", ["--fasta", FIX + "/fam20.fasta"]),
    ("c5_rep8_t.fasta", ["--fasta", "--read_repeats", FIX + "/rep8.trd",
                         "-t", G + "/tree0_rep8.nwk", FIX + "/rep8.fasta"]),
    ("c3_dna.fasta", ["--fasta", "--dna", "--custom_model",
                      FIX + "/dna.qmat", FIX + "/dna12.fasta"]),
    # free tree from NW distances, re-trees from the prealigned statistics
    ("c2_fam20.fasta", ["--fasta", "--mldist", "--nwdist",
                        FIX + "/fam20.fasta"]),
]


@pytest.fixture(autouse=True)
def _one_torch_thread(monkeypatch):
    """The CLI subprocesses run the plain versions: thousands of small torch
    ops, which torch's intra-op thread pool slows down many times over when
    parallel test workers share the cores."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def _check(golden, out, stderr):
    with open(out) as f:
        mine = f.read()
    with open(os.path.join(G, golden)) as f:
        assert _strip_header(mine) == _strip_header(f.read())
    stderr_golden = os.path.join(G, os.path.splitext(golden)[0] + ".stderr")
    if os.path.exists(stderr_golden):
        with open(stderr_golden) as f:
            assert stderr == f.read()


def run_port_case(golden, args, tmp_path):
    out = str(tmp_path / "out")
    stderr = run_cli(args + ["--engine", "torch", "--device", "cpu"], out,
                     module="prographmsa_tpu_torch.cli")
    _check(golden, out, stderr)


@pytest.mark.parametrize("golden,args", CASES, ids=[c[0] for c in CASES])
def test_port_cli_golden(golden, args, tmp_path):
    run_port_case(golden, args, tmp_path)


@pytest.mark.parametrize("golden,args", DIST_CASES,
                         ids=[c[0] for c in DIST_CASES])
def test_port_dist_cli_golden(golden, args, tmp_path):
    out = str(tmp_path / "out.tsv")
    run_cli(args + ["--device", "cpu"], out,
            module="prographmsa_tpu_torch.dist_cli")
    with open(out) as f, open(os.path.join(G, golden)) as g:
        assert f.read() == g.read()


def test_port_cli_device_engine_golden(tmp_path):
    """``--engine device`` (the float32 stages on the card too) on a fixed
    tree, whose output the distances do not touch."""
    out = str(tmp_path / "out")
    golden, args = CASES[1]
    stderr = run_cli(args + ["--engine", "device", "--device", "cpu"], out,
                     module="prographmsa_tpu_torch.cli")
    _check(golden, out, stderr)


def test_auto_engine_needs_cuda(tmp_path):
    p = subprocess.run(
        [sys.executable, "-m", "prographmsa_tpu_torch.cli", "--fasta",
         "--engine", "auto", "--device", "cpu", FIX + "/fam6.fasta", "-o",
         str(tmp_path / "out")], cwd=REPO, capture_output=True, text=True,
        timeout=300)
    assert p.returncode == 2
    assert "--engine auto" in p.stderr
    assert not (tmp_path / "out").exists()


def test_port_cli_native_engine_golden(tmp_path):
    out = str(tmp_path / "out")
    golden, args = CASES[0]
    stderr = run_cli(args + ["--engine", "native"], out,
                     module="prographmsa_tpu_torch.cli")
    _check(golden, out, stderr)


def test_port_never_imports_jax(tmp_path):
    """A fixed-tree pass and a free-tree root search (``-r``) in one
    process: neither imports jax nor the JAX package."""
    out = str(tmp_path / "out")
    out_r = str(tmp_path / "out_r")
    code = (
        "import sys\n"
        "from prographmsa_tpu_torch.cli import main\n"
        "rc = main(['--fasta', '-t', %r, %r, '--device', 'cpu',"
        " '--timings', '-o', %r])\n"
        "assert rc == 0, rc\n"
        "rc = main(['--fasta', '-r', %r, '--device', 'cpu', '-o', %r])\n"
        "assert rc == 0, rc\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "stray = [m for m in sys.modules if m == 'prographmsa_tpu'"
        " or m.startswith('prographmsa_tpu.')]\n"
        "assert not stray, stray\n"
        "print('NO-JAX')\n" % (G + "/tree0_fam6.nwk", FIX + "/fam6.fasta",
                               out, FIX + "/fam6.fasta", out_r))
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=600)
    assert "NO-JAX" in p.stdout, p.stderr[-2000:]
    assert "torch_pairs_device       5" in p.stderr
    assert "torch_levels_device      3" in p.stderr   # every level on it
    assert "torch_levels_host" not in p.stderr
    with open(out) as f, open(G + "/t_fam6.fasta") as g:
        assert f.read() == g.read()
    with open(out_r) as f, open(G + "/r_fam6.fasta") as g:
        assert f.read() == g.read()
    assert "best gap parsimony score: 7" in p.stderr


def test_cuda_device_without_cuda_exits(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    p = subprocess.run(
        [sys.executable, "-m", "prographmsa_tpu_torch.cli", "--fasta",
         FIX + "/fam6.fasta", "-o", str(tmp_path / "out")], cwd=REPO,
        capture_output=True, text=True, timeout=300)
    assert p.returncode == 2
    assert "is_available() is false" in p.stderr
