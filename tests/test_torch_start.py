"""Process start of the port's CLI: the first guide tree is built in a
process of its own while the CLI imports torch (prographmsa_tpu_torch/
first_tree.py), equal to the tree built in process; that process imports
no torch, nor does a run under ``--engine native``; the input is read once,
so a pipe, /dev/stdin or a FIFO gives the golden; a missing device exits
as before and stops the tree's process; the CLI run twice in one process
writes the same bytes.
"""

import json
import os
import subprocess
import sys
import threading

import pytest
import torch

from prographmsa_tpu_torch import cli, first_tree, timings
from prographmsa_tpu_torch.io.fasta import read_text
from prographmsa_tpu_torch.tree.phytree import PhyTree

from test_e2e_differential import FIX, G, REPO

NO_CUDA = ("device 'cuda' requested but torch.cuda.is_available() is "
           "false")
MALFORMED = "no fasta record\n"


@pytest.fixture(autouse=True)
def _one_torch_thread(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def _python(code, timeout=300, stdin=None):
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       stdin=stdin, capture_output=True, timeout=timeout)
    assert p.returncode == 0, p.stderr[-3000:]
    return p.stdout, p.stderr.decode()


# refuses torch in any process but the one that ran this
REFUSE_TORCH_APART = r"""
import os, sys
MAIN = os.getpid()
class RefuseApart:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] == "torch" and os.getpid() != MAIN:
            raise ImportError("torch imported in the tree's process")
        return None
sys.meta_path.insert(0, RefuseApart())
"""


def _golden(name):
    with open(os.path.join(G, name)) as f:
        return f.read()


def _options(path, *flags):
    args = cli.build_parser().parse_args(["--fasta", *flags, path])
    return cli.options_from_args(args).replace(engine="native")


def test_native_engine_imports_no_torch(tmp_path):
    out = str(tmp_path / "out")
    got, _ = _python(
        "import sys\n"
        "from prographmsa_tpu_torch.cli import main\n"
        "rc = main(['--fasta', '--engine', 'native', %r, '-o', %r])\n"
        "print(rc, sorted(m for m in sys.modules if m == 'torch'"
        " or m.startswith('torch.')))\n" % (FIX + "/fam20.fasta", out))
    assert got.decode().split("\n")[0] == "0 []"
    with open(out) as f:
        assert f.read() == _golden("c1_fam20.fasta")


def test_first_tree_is_built_apart_while_torch_is_imported(tmp_path):
    """In a fresh CLI process the tree's process starts before torch is
    imported, and its tree is taken after: the recorded order of events.
    The output is the golden's and --timings holds the tree's phases."""
    out = str(tmp_path / "out")
    got, err = _python(
        "import json, sys\n"
        "events = []\n"
        "class Spy:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name == 'torch':\n"
        "            events.append('torch imported')\n"
        "        return None\n"
        "sys.meta_path.insert(0, Spy())\n"
        "from prographmsa_tpu_torch import cli, first_tree\n"
        "init, tree = first_tree.Apart.__init__, first_tree.Apart.tree\n"
        "def started(self, *a):\n"
        "    init(self, *a)\n"
        "    events.append('tree process started: %%s' %% self.started)\n"
        "def taken(self):\n"
        "    t = tree(self)\n"
        "    events.append('tree taken')\n"
        "    return t\n"
        "first_tree.Apart.__init__ = started\n"
        "first_tree.Apart.tree = taken\n"
        "rc = cli.main(['--fasta', '-i', '0', '--timings', '--device',"
        " 'cpu', %r, '-o', %r])\n"
        "print(json.dumps([rc, events]))\n" % (FIX + "/fam6.fasta", out))
    rc, events = json.loads(got.decode().strip().split("\n")[-1])
    assert rc == 0
    assert events == ["tree process started: True", "torch imported",
                      "tree taken"], events
    with open(out) as f:
        assert f.read() == _golden("i0_fam6.fasta")
    report = err.partition("timings (wall seconds")[2]
    phases = {ln.split()[0] for ln in report.splitlines()[1:]
              if ln.startswith("  ")}
    assert {"card_start", "tree_wait", "distances_apart",
            "nj_apart"} <= phases, phases
    assert not {"distances", "nj"} & phases, phases


@pytest.mark.parametrize("engine,flags,pays", [
    ("torch", (), True), ("auto", (), True), ("native", (), False),
    ("device", (), False), ("torch", ("--nwdist",), False),
    ("torch", ("-t", G + "/tree0_fam6.nwk"), False),
    ("torch", ("--checkpoint_dir", "ck"), False)])
def test_first_tree_is_built_apart_only_where_it_pays(engine, flags, pays,
                                                      monkeypatch):
    """Apart when the run will import torch and the first tree is built on
    the host: not under native (no torch), not when a card stage or a file
    gives the tree, never once torch is imported."""
    options = _options(FIX + "/fam6.fasta", *flags)
    assert not first_tree.pays(options, engine)     # torch is imported
    monkeypatch.delitem(sys.modules, "torch")
    assert first_tree.pays(options, engine) == pays


def _apart(options, monkeypatch):
    monkeypatch.setattr(first_tree, "pays", lambda *a: True)
    text = read_text(options.sequence_file)
    with first_tree.Apart(text, options, "torch") as apart:
        assert apart.started
        return apart.tree()


def test_first_tree_apart_equals_in_process(monkeypatch):
    """The tree built apart is the one built in process, bit for bit, and
    its distances and NJ phases reach this process's --timings table under
    names of their own."""
    options = _options(FIX + "/fam20.fasta")
    here = first_tree.first_tree(read_text(options.sequence_file), options,
                                 "torch")
    timings.enable(True)
    try:
        apart = _apart(options, monkeypatch)
        phases = set(timings.recorded()[0])
    finally:
        timings.enable(False)
    assert apart.format_newick() == here.format_newick()
    assert phases == {"distances_apart", "nj_apart", "tree_wait"}, phases


def test_first_tree_apart_raises_the_error_here(tmp_path, monkeypatch):
    one = tmp_path / "one.fasta"
    one.write_text(">a\nACDEFGHIK\n")
    options = _options(str(one))
    with pytest.raises(ValueError) as here:
        first_tree.first_tree(one.read_text(), options, "torch")
    with pytest.raises(ValueError) as apart:
        _apart(options, monkeypatch)
    assert str(apart.value) == str(here.value)


def test_first_tree_process_imports_no_torch():
    """In a fresh process, with torch refused to every other process, the
    tree built apart is the golden's."""
    out, _ = _python(
        REFUSE_TORCH_APART +
        "from prographmsa_tpu_torch import cli, first_tree\n"
        "args = cli.build_parser().parse_args(['--fasta', %r])\n"
        "options = cli.options_from_args(args).replace(engine='native')\n"
        "text = open(options.sequence_file).read()\n"
        "with first_tree.Apart(text, options, 'torch') as apart:\n"
        "    assert apart.started\n"
        "    print(apart.tree().format_newick())\n" % (FIX + "/fam6.fasta"))
    assert out.decode() == _golden("tree0_fam6.nwk")


@pytest.mark.parametrize("how", ["redirect", "pipe", "fifo"])
def test_input_read_once(how, tmp_path):
    """/dev/stdin from a file or a pipe, and a FIFO, can be read once:
    the CLI reads the input once and hands its text to the tree's process.
    The output is the golden's, built apart."""
    fasta, path = FIX + "/fam6.fasta", "/dev/stdin"
    out = str(tmp_path / "out")
    code = ("import sys\nfrom prographmsa_tpu_torch.cli import main\n"
            "sys.exit(main(['--fasta', '-i', '0', '--timings', '--device',"
            " 'cpu', %r, '-o', %r]))\n")
    if how == "fifo":
        path = str(tmp_path / "fifo")
        os.mkfifo(path)

        def feed():
            with open(path, "w") as w, open(fasta) as r:
                w.write(r.read())

        writer = threading.Thread(target=feed)
        writer.start()
        _, err = _python(code % (path, out), stdin=subprocess.DEVNULL)
        writer.join()
    elif how == "pipe":
        cat = subprocess.Popen(["cat", fasta], stdout=subprocess.PIPE)
        _, err = _python(code % (path, out), stdin=cat.stdout)
        cat.stdout.close()
        assert cat.wait() == 0
    else:
        with open(fasta) as f:
            _, err = _python(code % (path, out), stdin=f)
    with open(out) as f:
        assert f.read() == _golden("i0_fam6.fasta")
    assert "  tree_wait " in err, err


def test_tree_is_sent_flat_whatever_its_depth():
    """The tree crosses the pipe as rows: a caterpillar of 3000 levels,
    deeper than pickle nests, comes back node for node."""
    root = node = PhyTree("r")
    for i in range(3000):
        child = PhyTree("i%d" % i)
        node.add_child(child, 0.125 * i, 0.5)
        node.add_child(PhyTree("l%d" % i), 1.0 / (i + 1), 1.0)
        node = child
    rows = first_tree.flatten(root)
    back = first_tree.unflatten(rows)
    assert first_tree.flatten(back) == rows and len(rows) == 6001
    assert back.children[0].children[1].name == "l1"
    assert back.children[0].children[1].branch_length == 0.5


def _run_main(args, capsys):
    rc = cli.main(args)
    return rc, capsys.readouterr().err


@pytest.mark.parametrize("malformed", [False, True],
                         ids=["valid", "malformed"])
def test_missing_device_exits_2_and_stops_the_tree(malformed, tmp_path,
                                                   monkeypatch, capsys):
    """The device is resolved before the input is read: a missing one is
    the error reported, exit 2, also with a malformed input; no output is
    written and the tree's process, started before, is stopped."""
    def missing(engine, name):
        raise RuntimeError(NO_CUDA)

    started = []
    init = first_tree.Apart.__init__

    def recorded(self, *a):
        init(self, *a)
        started.append(self)

    monkeypatch.setattr(cli, "engine_device", missing)
    monkeypatch.setattr(first_tree, "pays", lambda *a: True)
    monkeypatch.setattr(first_tree.Apart, "__init__", recorded)
    fasta = FIX + "/fam6.fasta"
    if malformed:
        fasta = str(tmp_path / "bad.fasta")
        with open(fasta, "w") as f:
            f.write(MALFORMED)
    out = tmp_path / "out"
    rc, err = _run_main(["--fasta", fasta, "-o", str(out)], capsys)
    assert (rc, err) == (2, "error: %s\n" % NO_CUDA)
    assert not out.exists()
    assert len(started) == 1 and started[0].proc.exitcode is not None


@pytest.mark.parametrize("fasta", ["fam6.fasta", None],
                         ids=["valid", "malformed"])
def test_cuda_without_cuda_exits_2(fasta, tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    if fasta is None:
        path = str(tmp_path / "bad.fasta")
        with open(path, "w") as f:
            f.write(MALFORMED)
    else:
        path = FIX + "/" + fasta
    out = tmp_path / "out"
    rc, err = _run_main(["--fasta", path, "-o", str(out)], capsys)
    assert (rc, err) == (2, "error: %s\n" % NO_CUDA)
    assert not out.exists()


def test_warm_start_builds_the_tree_in_process(tmp_path, monkeypatch,
                                               capsys):
    """With torch imported there is no import to hide: the tree is built
    in this process."""
    def apart(self):
        raise AssertionError("built apart beside a warm start")

    monkeypatch.setattr(first_tree.Apart, "tree", apart)
    out = tmp_path / "out"
    rc, err = _run_main(["--fasta", "-i", "0", "--device", "cpu",
                         FIX + "/fam6.fasta", "-o", str(out)], capsys)
    assert rc == 0, err
    assert out.read_text() == _golden("i0_fam6.fasta")


def test_main_twice_in_one_process(tmp_path, capsys):
    """Two runs in one process: the same bytes, the golden's, and the
    start reported in each."""
    outs = []
    try:
        for k in range(2):
            out = tmp_path / ("out%d" % k)
            rc, err = _run_main(["--fasta", "--timings", "-t",
                                 G + "/tree0_fam6.nwk", "--device", "cpu",
                                 FIX + "/fam6.fasta", "-o", str(out)],
                                capsys)
            assert rc == 0, err
            head, _, report = err.partition("timings (wall seconds")
            assert head == _golden("t_fam6.stderr")
            assert "  card_start " in report, report
            outs.append(out.read_bytes())
    finally:
        timings.enable(False)
    assert outs[0] == outs[1] == _golden("t_fam6.fasta").encode()
