"""The free-tree cases of the golden corpus through the port's CLI on
``--device cpu`` (tests/test_torch_cli_corpus.py says how the list is
cut)."""

import pytest

from test_torch_cli import _one_torch_thread, run_port_case  # noqa: F401
from test_torch_cli_corpus import FREE


@pytest.mark.parametrize("golden,args", FREE, ids=[c[0] for c in FREE])
def test_port_cli_corpus_free_tree(golden, args, tmp_path):
    run_port_case(golden, args, tmp_path)
