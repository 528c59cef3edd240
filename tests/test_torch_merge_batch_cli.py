"""The card tier's CLI on ``--device cpu`` (the kernels' plain PyTorch
versions) with the level's host stage in native batches
(engine/level_driver.py) at ``PROGRAPHMSA_THREADS`` 1 and 8: t_fam20,
r_fam20 and rep8 on its golden tree, each its golden byte for byte,
output and stderr.  The native tier's runs of the same goldens and the
module tests are in test_torch_merge_batch.py."""

import pytest

from test_torch_cli import run_port_case
from test_torch_merge_batch import CLI


@pytest.mark.parametrize("threads", ["1", "8"])
@pytest.mark.parametrize("golden,args", CLI, ids=[c[0] for c in CLI])
def test_card_tier_cli_golden(golden, args, threads, tmp_path, monkeypatch):
    monkeypatch.setenv("PROGRAPHMSA_THREADS", threads)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    run_port_case(golden, args, tmp_path)
