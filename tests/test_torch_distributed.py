"""The port's process groups (prographmsa_tpu_torch/parallel/
distributed.py) on the CPU: disabled, a one-process cluster under both
sets of topology names, and a real two-process ``gloo`` cluster on
localhost that splits S1, S4 and the DP batch over both processes' shards
and runs the port's CLI in both, each against one process and the golden,
also with one ``--checkpoint_dir`` shared by both processes (written by
process 0, resumed by both) and with one per process (states that differ
raise in both).
The JAX package's counterpart is tests/test_distributed2.py.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from prographmsa_tpu_torch.parallel import distributed

from test_e2e_differential import FIX, G, REPO

JOIN = "prographmsa: joined distributed cluster as process"
TOPOLOGY = ("PROGRAPHMSA_DIST", "PROGRAPHMSA_COORD",
            "PROGRAPHMSA_NUM_PROCESSES", "PROGRAPHMSA_PROCESS_ID",
            "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _env(**kv):
    env = {k: v for k, v in os.environ.items() if k not in TOPOLOGY}
    env.pop("PYTEST_CURRENT_TEST", None)
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=REPO, **kv)
    return env


def _dist_env(port, rank, world=2):
    return _env(PROGRAPHMSA_DIST="1",
                PROGRAPHMSA_COORD="127.0.0.1:%d" % port,
                PROGRAPHMSA_NUM_PROCESSES=str(world),
                PROGRAPHMSA_PROCESS_ID=str(rank))


def _run_all(cmds_envs, timeout=420):
    """Start every (argv, env) at once; (returncode, stdout, stderr) each.
    Every process is killed if one outlasts ``timeout``."""
    procs = [subprocess.Popen(cmd, env=env, cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for cmd, env in cmds_envs]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def test_disabled_is_a_no_op(monkeypatch):
    for k in TOPOLOGY:
        monkeypatch.delenv(k, raising=False)
    assert not distributed.is_enabled()
    assert distributed.maybe_initialize() is False
    assert not distributed.active()
    assert (distributed.rank(), distributed.world()) == (0, 1)
    a = np.arange(5, dtype=np.int32)
    (got,) = distributed.all_gather(a)
    assert np.array_equal(got, a)
    assert distributed.broadcast([1.5, 2]) == [1.5, 2.0]
    m = distributed.global_mesh(("cpu", "cpu"))
    assert (m.size, m.offset, m.world) == (2, 0, 1)


def test_topology_names(monkeypatch):
    for k in TOPOLOGY:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("PROGRAPHMSA_DIST", "1")
    with pytest.raises(RuntimeError, match="PROGRAPHMSA_COORD"):
        distributed.maybe_initialize()
    assert not distributed.active()
    monkeypatch.setenv("MASTER_ADDR", "10.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "29500")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "3")
    assert distributed.topology() == ("tcp://10.0.0.1:29500", 4, 3)
    monkeypatch.setenv("PROGRAPHMSA_COORD", "h0:8476")
    monkeypatch.setenv("PROGRAPHMSA_NUM_PROCESSES", "2")
    monkeypatch.setenv("PROGRAPHMSA_PROCESS_ID", "1")
    assert distributed.topology() == ("tcp://h0:8476", 2, 1)


ONE = r"""
import numpy as np, torch
from prographmsa_tpu_torch.parallel import distributed, sharded
assert distributed.maybe_initialize(torch.device("cpu"))
assert distributed.maybe_initialize(torch.device("cpu"))
assert (distributed.rank(), distributed.world()) == (0, 1)
mesh = distributed.mesh_for("cpu")
assert (mesh.size, mesh.offset, mesh.world) == (1, 0, 1)
v = np.array([[0, 1, 1, -1, 25]], np.int32)
assert sharded.sharded_freq_hist(mesh, v, 20)[:2].tolist() == [1.0, 2.0]
distributed.shutdown()
assert not distributed.active()
print("ONE-OK")
"""


@pytest.mark.parametrize("names", ["prographmsa", "torchrun"])
def test_one_process_cluster(names):
    port = _free_port()
    if names == "prographmsa":
        env = _dist_env(port, 0, world=1)
    else:
        env = _env(PROGRAPHMSA_DIST="1", MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), WORLD_SIZE="1", RANK="0")
    ((rc, out, err),) = _run_all([([sys.executable, "-c", ONE], env)],
                                 timeout=180)
    assert rc == 0, err[-3000:]
    assert "ONE-OK" in out
    assert err.count(JOIN) == 1
    assert "process 0/1 (1 local / 1 global shards)" in err


TWO = r"""
import numpy as np, torch
torch.set_num_threads(1)
from prographmsa_tpu_torch import checks, engine_policy
from prographmsa_tpu_torch.align import graph_dp_cuda as gdp
from prographmsa_tpu_torch.distances.align import GAP_PARAMS, _load_scoring
from prographmsa_tpu_torch.distances.nw_cuda import nw_counts
from prographmsa_tpu_torch.parallel import distributed, sharded

cpu = torch.device("cpu")
assert distributed.maybe_initialize(cpu)
r = distributed.rank()
assert distributed.world() == 2

# S1 over uneven local meshes: 1 shard in process 0, 3 in process 1
mesh = distributed.global_mesh((cpu,) * (1 + 2 * r))
assert (mesh.size, mesh.offset) == (4, 0 if r == 0 else 1)
scoring = _load_scoring("aa")
go, ge = GAP_PARAMS["aa"]
rng = np.random.default_rng(7)
for B in (16, 3):
    s1 = rng.integers(0, 20, (B, 12)).astype(np.int32)
    s2 = rng.integers(0, 20, (B, 12)).astype(np.int32)
    l1 = rng.integers(6, 13, B).astype(np.int32)
    l2 = rng.integers(6, 13, B).astype(np.int32)
    c, g = sharded.sharded_nw_counts(mesh, s1, s2, l1, l2, scoring, go, ge,
                                     20)
    t = torch.from_numpy
    c0, g0 = nw_counts(t(s1), t(s2), t(l1), t(l2), t(scoring), go, ge, 20)
    assert np.array_equal(c, c0.numpy()) and np.array_equal(g, g0.numpy())

# S4: a count per shard, summed, then all_reduce
v = rng.integers(-1, 22, (16, 24)).astype(np.int32)
h = sharded.sharded_freq_hist(mesh, v, 20)
want = np.bincount(v[(v >= 0) & (v < 20)], minlength=20).astype(np.float32)
assert np.array_equal(h, want), (h, want)

# the DP batch over 2 x 2 shards against the host, counters as one process
mesh = distributed.global_mesh((cpu, cpu))
assert (mesh.size, mesh.offset) == (4, 2 * r)
m = checks.model(0.4)
grng = np.random.default_rng(21)
pairs = [(checks.chain(checks.random_seq(grng, 18)),
          checks.chain(checks.random_seq(grng, 16)), m) for _ in range(9)]
pairs.append((checks.merged("ACDEFGHIKLMNPQRSTVWY", "ACDEFGIKMNPQRSTVWY", m),
              checks.chain("ACDEFGHIKLMNPQRSTVW"), m))
items, expected = checks.items_and_expected(pairs)
for batch in (items, items[:3]):
    before = gdp.fallback_stats()
    res = gdp.align_pairs_device(batch, cpu, mesh)
    after = gdp.fallback_stats()
    assert all(checks.same_alignment(x, a) for x, a in zip(res, expected))
    assert after["pairs_device"] - before["pairs_device"] == len(batch)
    assert after["pairs_total"] - before["pairs_total"] == len(batch)

# auto's calibration: process 0's, in both
engine_policy._calibrate = lambda: {"roundtrip_s": 1e-4 * (r + 1),
                                    "fetch_mbps": 1000.0 * (r + 1)}
c = engine_policy.calibration()
assert c["roundtrip_s"] == 1e-4 and c["fetch_mbps"] == 1000.0, c
print("TWO-OK", r)
"""


def test_two_process_cluster():
    port = _free_port()
    outs = _run_all([([sys.executable, "-c", TWO], _dist_env(port, r))
                     for r in (0, 1)])
    for r, (rc, out, err) in enumerate(outs):
        assert rc == 0, "process %d failed:\n%s" % (r, err[-3000:])
        assert "TWO-OK %d" % r in out
        assert "process %d/2 (1 local / 2 global shards)" % r in err


def _counters(err):
    return {ln.split()[0]: int(ln.split()[1]) for ln in
            err.split("counters:")[-1].strip().splitlines()}


def test_two_process_cli_free_tree(tmp_path):
    """fam20 --mldist --nwdist in two processes of one cluster (the NW
    chunks and every DP batch split over their two shards) and alone: each
    output the golden's, each stderr the golden's less the join line and
    the --timings report, the counters those of the one process."""
    args = ["-m", "prographmsa_tpu_torch.cli", "--fasta", "--mldist",
            "--nwdist", "--device", "cpu", "--timings", FIX + "/fam20.fasta"]
    port = _free_port()
    runs = [([sys.executable, *args, "-o", str(tmp_path / ("out%d" % r))],
             _dist_env(port, r)) for r in (0, 1)]
    runs.append(([sys.executable, *args, "-o", str(tmp_path / "alone")],
                 _env()))
    outs = _run_all(runs, timeout=600)
    for rc, _out, err in outs:
        assert rc == 0, err[-3000:]
    alone = _counters(outs[2][2])
    assert alone["torch_pairs_total"] > 0
    with open(os.path.join(G, "c2_fam20.fasta")) as f:
        golden = f.read()
    with open(os.path.join(G, "c2_fam20.stderr")) as f:
        golden_err = f.read()
    for r in (0, 1):
        err = outs[r][2]
        assert err.count(JOIN) == 1
        lines = [ln for ln in err.splitlines(True) if not ln.startswith(JOIN)]
        assert "".join(lines).split("timings (wall seconds")[0] == golden_err
        assert _counters(err) == alone
        with open(tmp_path / ("out%d" % r)) as f:
            assert f.read() == golden


def _phases(err):
    """The phase names of a --timings report."""
    report = err.split("timings (wall seconds")[1].split("counters:")[0]
    return {ln.split()[0] for ln in report.splitlines()[1:] if ln.strip()}


def test_two_process_cli_checkpoint(tmp_path):
    """fam20 --mldist --nwdist in two processes sharing one
    --checkpoint_dir: both golden, one state file (process 0's) and no
    temporary file left; run again, both resume (no distances, no NJ) and
    are golden again, with every pair of the final pass on --device."""
    ck = str(tmp_path / "ck")
    args = ["-m", "prographmsa_tpu_torch.cli", "--fasta", "--mldist",
            "--nwdist", "--device", "cpu", "--timings", "--checkpoint_dir",
            ck, FIX + "/fam20.fasta"]
    with open(os.path.join(G, "c2_fam20.fasta")) as f:
        golden = f.read()
    with open(os.path.join(G, "c2_fam20.stderr")) as f:
        golden_err = f.read()
    for run in ("first", "resumed"):
        port = _free_port()
        outs = _run_all([([sys.executable, *args, "-o",
                           str(tmp_path / ("%s%d" % (run, r)))],
                          _dist_env(port, r)) for r in (0, 1)], timeout=600)
        for r, (rc, _out, err) in enumerate(outs):
            assert rc == 0, err[-3000:]
            lines = [ln for ln in err.splitlines(True)
                     if not ln.startswith(JOIN)]
            assert "".join(lines).split("timings (wall seconds")[0] \
                == golden_err, (run, r)
            with open(tmp_path / ("%s%d" % (run, r))) as f:
                assert f.read() == golden, (run, r)
            ctr = _counters(err)
            assert ctr["torch_pairs_device"] == ctr["torch_pairs_total"] > 0
            phases = _phases(err)
            if run == "resumed":
                assert not phases & {"distances", "nj"}, (r, phases)
            else:
                assert {"distances", "nj"} <= phases, (r, phases)
        assert os.listdir(ck) == ["phase_state_torch.pkl"], os.listdir(ck)


def test_two_process_differing_states_raise(tmp_path):
    """Each process its own --checkpoint_dir, only process 0's filled: both
    processes exit non-zero naming the mismatch, and neither waits for the
    other (``_run_all``'s timeout)."""
    args = ["-m", "prographmsa_tpu_torch.cli", "--fasta", "--device", "cpu",
            FIX + "/fam6.fasta"]
    dirs = [str(tmp_path / ("ck%d" % r)) for r in (0, 1)]
    ((rc, _out, err),) = _run_all([([sys.executable, *args,
                                     "--checkpoint_dir", dirs[0], "-o",
                                     str(tmp_path / "alone")], _env())],
                                  timeout=300)
    assert rc == 0, err[-3000:]
    port = _free_port()
    outs = _run_all([([sys.executable, *args, "--checkpoint_dir", dirs[r],
                       "-o", str(tmp_path / ("out%d" % r))],
                      _dist_env(port, r)) for r in (0, 1)], timeout=300)
    for r, (rc, _out, err) in enumerate(outs):
        assert rc != 0, (r, err[-3000:])
        assert "the processes found different states (i_next by rank, -1 " \
               "for none: [2, -1])" in err, (r, err[-3000:])
    assert os.listdir(dirs[1]) == []
