"""The rest of the golden corpus (tests/test_e2e_differential.py's cases
that tests/test_torch_cli.py does not run) through the port's CLI on
``--device cpu`` (the card's stages on their plain PyTorch versions),
byte for byte, stderr included where a golden holds it.  The list is cut
in three files so that parallel workers share it: the fixed-tree and
``-T`` cases here, the free-tree cases in test_torch_cli_corpus_free.py,
the root search and early refinement in test_torch_cli_reroot.py.
chip_smoke.py (phase ``corpus``) runs the same list on the card.
"""

import pytest

from test_e2e_differential import CASES as E2E_CASES
from test_torch_cli import CASES, _one_torch_thread  # noqa: F401
from test_torch_cli import run_port_case

_PORTED = {golden for golden, _args in CASES}
REST = [c for c in E2E_CASES if c[0] not in _PORTED]
REROOT = [c for c in REST if "-r" in c[1] or "--early_refinement" in c[1]]
FIXED = [c for c in REST if c not in REROOT
         and ("-t" in c[1] or "-T" in c[1])]
FREE = [c for c in REST if c not in REROOT and c not in FIXED]


@pytest.mark.parametrize("golden,args", FIXED, ids=[c[0] for c in FIXED])
def test_port_cli_corpus_fixed_tree(golden, args, tmp_path):
    run_port_case(golden, args, tmp_path)
