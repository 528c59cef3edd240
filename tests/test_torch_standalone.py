"""The PyTorch/CUDA port stands alone: no module of prographmsa_tpu_torch/
and none of the root scripts chip_smoke.py, k3_sweep.py, k1_x1_probe.py,
root_score_time.py and startup_time.py imports ``jax`` or
anything of the JAX package ``prographmsa_tpu``, and with both names refused by the import system the
port's CLI still reproduces the fam20 goldens byte for byte (stdout and
stderr) on ``--device cpu`` and with its own ``--engine native``.
"""

import ast
import glob
import os
import subprocess
import sys

import pytest

from test_e2e_differential import FIX, G, REPO, _strip_header

REPO = os.path.abspath(REPO)
PORT = os.path.join(REPO, "prographmsa_tpu_torch")
SOURCES = sorted(glob.glob(os.path.join(PORT, "**", "*.py"), recursive=True))
SOURCES += [os.path.join(REPO, name) for name in
            ("chip_smoke.py", "k3_sweep.py", "k1_x1_probe.py",
             "root_score_time.py", "startup_time.py")]

FAM20 = [
    ("t_fam20.fasta", ["--fasta", "-t", G + "/tree0_fam20.nwk",
                       FIX + "/fam20.fasta"]),
    ("c1_fam20.fasta", ["--fasta", FIX + "/fam20.fasta"]),
]

# refuses the two names before any finder sees them, then runs the CLI
BLOCKED_RUN = r"""
import os
import sys


class Refuse:
    def find_spec(self, name, path=None, target=None):
        root = name.split(".")[0]
        if root in ("jax", "jaxlib", "prographmsa_tpu"):
            raise ImportError("refused in this test: " + name)
        return None


sys.meta_path.insert(0, Refuse())
from prographmsa_tpu_torch import native
from prographmsa_tpu_torch.cli import main

rc = main(sys.argv[1:])
if "native" in sys.argv:
    assert native.available(), "the port's native library did not build"
    so = os.path.realpath(native._SO)
    port = os.path.realpath(os.path.dirname(os.path.dirname(
        native.__file__)))
    assert so.startswith(port + os.sep), (so, port)
    assert "graphcore-torch-" in os.path.basename(so), so
    print("NATIVE-LOADED", file=sys.stderr)
stray = [m for m in sys.modules if m.split(".")[0] in
         ("jax", "jaxlib", "prographmsa_tpu")]
assert not stray, stray
sys.exit(rc)
"""


def _forbidden(name):
    return (name == "jax" or name.startswith("jax.")
            or name == "prographmsa_tpu"
            or name.startswith("prographmsa_tpu."))


def _imports(path):
    """Every module name a file imports (absolute imports only; a relative
    import stays inside the port by construction)."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name, node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module, node.lineno


@pytest.mark.parametrize("path", SOURCES,
                         ids=[os.path.relpath(p, REPO) for p in SOURCES])
def test_no_import_of_jax_or_the_jax_package(path):
    bad = [(name, line) for name, line in _imports(path) if _forbidden(name)]
    assert not bad, "%s imports %s" % (os.path.relpath(path, REPO), bad)
    with open(path) as f:
        text = f.read()
    assert "prographmsa_tpu.cli" not in text.replace(
        "prographmsa_tpu/cli.py", ""), "starts the JAX package's CLI"


def _run_blocked(args, out):
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONWARNINGS="ignore")
    env.pop("JAX_PLATFORMS", None)
    p = subprocess.run([sys.executable, "-c", BLOCKED_RUN, *args, "-o", out],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    return p.stderr


def _check(golden, out, stderr):
    with open(out) as f, open(os.path.join(G, golden)) as g:
        assert _strip_header(f.read()) == _strip_header(g.read())
    stderr_golden = os.path.join(G, os.path.splitext(golden)[0] + ".stderr")
    if os.path.exists(stderr_golden):
        with open(stderr_golden) as f:
            assert stderr == f.read()
    else:
        assert stderr == ""


@pytest.mark.parametrize("golden,args", FAM20, ids=[c[0] for c in FAM20])
def test_cli_device_cpu_with_the_jax_package_refused(golden, args, tmp_path):
    out = str(tmp_path / "out")
    stderr = _run_blocked(args + ["--engine", "torch", "--device", "cpu"],
                          out)
    _check(golden, out, stderr)


@pytest.mark.parametrize("golden,args", FAM20, ids=[c[0] for c in FAM20])
def test_cli_native_engine_with_the_jax_package_refused(golden, args,
                                                        tmp_path):
    out = str(tmp_path / "out")
    stderr = _run_blocked(args + ["--engine", "native"], out)
    assert stderr.endswith("NATIVE-LOADED\n"), stderr[-2000:]
    _check(golden, out, stderr[:-len("NATIVE-LOADED\n")])
