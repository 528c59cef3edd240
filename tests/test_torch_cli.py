"""The port's CLI (python -m prographmsa_tpu_torch.cli) against the goldens,
byte for byte, with the DP batch on ``--device cpu`` (the kernels' plain
PyTorch versions).  On the card chip_smoke.py drives the same CLI with
``--device cuda`` on fam100 and fam500.
"""

import os
import subprocess
import sys

import pytest
import torch

from test_e2e_differential import FIX, G, REPO, _strip_header, run_cli

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


@pytest.mark.parametrize("golden,args", CASES, ids=[c[0] for c in CASES])
def test_port_cli_golden(golden, args, tmp_path):
    out = str(tmp_path / "out")
    stderr = run_cli(args + ["--engine", "torch", "--device", "cpu"], out,
                     module="prographmsa_tpu_torch.cli")
    _check(golden, out, stderr)


def test_port_cli_native_engine_golden(tmp_path):
    out = str(tmp_path / "out")
    golden, args = CASES[0]
    stderr = run_cli(args + ["--engine", "native"], out,
                     module="prographmsa_tpu_torch.cli")
    _check(golden, out, stderr)


def test_port_never_imports_jax(tmp_path):
    out = str(tmp_path / "out")
    code = (
        "import sys\n"
        "from prographmsa_tpu_torch.cli import main\n"
        "rc = main(['--fasta', '-t', %r, %r, '--device', 'cpu',"
        " '--timings', '-o', %r])\n"
        "assert rc == 0, rc\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "print('NO-JAX')\n" % (G + "/tree0_fam6.nwk", FIX + "/fam6.fasta",
                               out))
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=600)
    assert "NO-JAX" in p.stdout, p.stderr[-2000:]
    assert "torch_pairs_device       5" in p.stderr
    with open(out) as f, open(G + "/t_fam6.fasta") as g:
        assert f.read() == g.read()


@pytest.mark.parametrize("flag", ["-r", "--early_refinement"])
def test_unported_flags_exit_with_error(flag, tmp_path):
    p = subprocess.run(
        [sys.executable, "-m", "prographmsa_tpu_torch.cli", "--fasta", flag,
         "--device", "cpu", FIX + "/fam6.fasta", "-o",
         str(tmp_path / "out")], cwd=REPO, capture_output=True, text=True,
        timeout=300)
    assert p.returncode == 2
    assert "ROADMAP" in p.stderr
    assert not (tmp_path / "out").exists()


def test_cuda_device_without_cuda_exits(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    p = subprocess.run(
        [sys.executable, "-m", "prographmsa_tpu_torch.cli", "--fasta",
         FIX + "/fam6.fasta", "-o", str(tmp_path / "out")], cwd=REPO,
        capture_output=True, text=True, timeout=300)
    assert p.returncode == 2
    assert "is_available() is false" in p.stderr
