"""The root search (``-r``, ``-r -r``) and ``--early_refinement`` goldens
through the port's CLI on ``--device cpu``, with ``r_fam20`` (whose stderr
holds the best gap-parsimony score) and the ``--profile_out`` case of
tests/test_e2e_differential.py.  tests/test_torch_find_root.py and
tests/test_torch_early_refinement.py hold the modules against the JAX
package and the port's sequential recursion."""

import os

import pytest

from test_e2e_differential import FIX, G, run_cli
from test_torch_cli import _one_torch_thread, run_port_case  # noqa: F401
from test_torch_cli_corpus import REROOT

CASES = REROOT + [("r_fam20.fasta", ["--fasta", "-r", FIX + "/fam20.fasta"])]


@pytest.mark.parametrize("golden,args", CASES, ids=[c[0] for c in CASES])
def test_port_cli_reroot_golden(golden, args, tmp_path):
    run_port_case(golden, args, tmp_path)


def test_port_cli_profile_out(tmp_path):
    out = str(tmp_path / "aln")
    prof = str(tmp_path / "prof")
    run_cli(["--fasta", "--profile_out", prof, "-t", G + "/tree0_fam20.nwk",
             FIX + "/fam20.fasta", "--device", "cpu"], out,
            module="prographmsa_tpu_torch.cli")
    with open(prof) as f, open(os.path.join(G, "t_fam20.profile")) as g:
        assert f.read() == g.read()
