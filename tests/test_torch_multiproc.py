"""The port's multi-process launch against the one-process run, on the CPU.

- ``repro_torch.common.env`` and ``repro_torch.launch.coordinator``: the
  jax-free units of ``tests/test_multiproc.py`` (``TestPreparse``,
  ``TestDistConfig``, ``TestCoordinator``), against the port's modules;
  ``NodeGroup`` and ``launch.mesh``.
- Gangs of ``tools/gang_check.py`` over gloo on localhost, N = 2 and 4
  ranks at P = 4 and 8 nodes (so a rank holds 1, 2 or 4 nodes): each
  collective of ``common.nodes`` equals its one-process tensor op, and
  every MalStone case (each backend; the sort, counting and columns
  exchanges; overlap on and off; the seed, log and streamed-log sources)
  gives every rank the histogram, rho bits and every ``ShuffleStats``
  field of the one-process run, which the other tests hold against JAX.
  On the log path rho also bit-equals JAX's ``malstone_single_device``
  over the same log.
- The launcher: ``--num-processes 2 --device cpu --check --bench-json``
  and ``--num-processes 4`` one-shot ``--check`` exit 0; a gang with
  ``--gen-device`` or ``--checkpoint-dir`` is JAX's argparse error; a rank
  that exits 3 makes the parent exit 3.

Every subprocess runs under a timeout, in a session of its own that is
killed whole if the timeout passes.
"""

import json
import os
import pathlib
import signal
import socket
import subprocess
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.types import EventLog as JaxLog
from repro.core import malstone_single_device as jax_single_device
from repro_torch.common import env, nodes
from repro_torch.core import runner
from repro_torch.launch import coordinator, malstone, mesh

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))
import gang_check  # noqa: E402

GANGS = ((2, (4, 8)), (4, (4, 8)))         # (ranks, node counts)
TIMEOUT = 240
CPU = torch.device("cpu")


def _env() -> dict:
    e = dict(os.environ)
    e["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + e.get("PYTHONPATH",
                                                            "")
    e.pop("XLA_FLAGS", None)
    return e


def _start(cmd) -> subprocess.Popen:
    return subprocess.Popen(cmd, cwd=ROOT, env=_env(), text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            start_new_session=True)


def _finish(proc: subprocess.Popen):
    """(returncode, stdout, stderr); the whole session is killed if the
    process outlives the timeout."""
    try:
        out, err = proc.communicate(timeout=TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        pytest.fail(f"{proc.args} outlived {TIMEOUT} s:\n{out}\n{err}")
    return proc.returncode, out, err


# ------------------------------------------------------ repro_torch.common.env
class TestPreparse:
    def test_last_occurrence_wins(self):
        argv = ["prog", "--nodes", "2", "--nodes=5"]
        assert env.preparse_flag("--nodes", None, argv) == "5"
        assert env.preparse_int_flag("--nodes", None, argv) == 5

    def test_space_and_eq_forms(self):
        assert env.preparse_flag("--x", None, ["p", "--x", "a"]) == "a"
        assert env.preparse_flag("--x", None, ["p", "--x=b"]) == "b"

    def test_default_when_absent(self):
        assert env.preparse_flag("--x", "d", ["p"]) == "d"
        assert env.preparse_int_flag("--x", 7, ["p"]) == 7
        assert env.preparse_nodes(argv=["p"]) == 2

    def test_trailing_flag_without_value_ignored(self):
        assert env.preparse_flag("--x", "d", ["p", "--x"]) == "d"


# ------------------------------------------------ repro_torch.launch.coordinator
class TestDistConfig:
    def test_single_process_default(self):
        cfg = coordinator.DistConfig()
        assert not cfg.is_distributed
        assert not cfg.is_spawn_parent
        assert not cfg.is_worker

    def test_spawn_parent_vs_worker(self):
        parent = coordinator.DistConfig(num_processes=2)
        assert parent.is_distributed and parent.is_spawn_parent
        assert not parent.is_worker
        worker = coordinator.DistConfig(num_processes=2, process_id=0)
        assert worker.is_distributed and worker.is_worker
        assert not worker.is_spawn_parent

    def test_preparse(self):
        cfg = coordinator.preparse(
            ["p", "--num-processes", "2", "--process-id", "1",
             "--coordinator", "127.0.0.1:1234"])
        assert cfg == coordinator.DistConfig(
            num_processes=2, process_id=1, coordinator="127.0.0.1:1234")

    def test_preparse_defaults(self):
        assert coordinator.preparse(["p"]) == coordinator.DistConfig()

    def test_banner(self):
        assert coordinator.process_banner(
            coordinator.DistConfig()) == "single-process"
        assert "1/2" in coordinator.process_banner(
            coordinator.DistConfig(2, 1, "h:1"))


class TestCoordinator:
    def test_pick_port_is_bindable(self):
        port = coordinator.pick_port()
        assert 0 < port < 65536
        with socket.socket() as s:
            s.bind(("127.0.0.1", port))

    def test_initialize_rejects_spawn_parent(self):
        with pytest.raises(ValueError, match="spawn parent"):
            coordinator.initialize(coordinator.DistConfig(num_processes=2))

    def test_initialize_requires_coordinator_for_worker(self):
        with pytest.raises(ValueError, match="--coordinator"):
            coordinator.initialize(
                coordinator.DistConfig(num_processes=2, process_id=0))

    def test_initialize_validates_rank_range(self):
        with pytest.raises(ValueError, match="out of range"):
            coordinator.initialize(coordinator.DistConfig(
                num_processes=2, process_id=5, coordinator="h:1"))

    def test_initialize_single_process_is_a_no_op(self):
        assert coordinator.initialize(coordinator.DistConfig()) is False

    def test_bootstrap_rejects_uneven_node_split(self):
        with pytest.raises(SystemExit, match="divide evenly"):
            coordinator.bootstrap(
                ["p", "--num-processes", "2", "--process-id", "0",
                 "--coordinator", "h:1"], local_devices_for=3)

    def test_spawn_local_appends_ranks_and_propagates_status(self):
        # each cheap worker exits with its own appended rank: rank 1's
        # nonzero status must surface as the gang status
        script = ("import sys;"
                  "sys.exit(int(sys.argv[sys.argv.index('--process-id')+1]))")
        cfg = coordinator.DistConfig(num_processes=2)
        assert coordinator.spawn_local(cfg, ["-c", script], timeout=60) == 1

    def test_spawn_local_all_ok(self):
        cfg = coordinator.DistConfig(num_processes=2)
        assert coordinator.spawn_local(cfg, ["-c", "pass"], timeout=60) == 0

    def test_a_rank_that_exits_3_makes_the_parent_exit_3(self):
        """Rank 2 exits 3 while the others wait: the parent exits 3 at
        once, and kills the waiting ranks."""
        script = ("import sys, time;"
                  "r = int(sys.argv[sys.argv.index('--process-id')+1]);"
                  "sys.exit(3) if r == 2 else time.sleep(60)")
        cfg = coordinator.DistConfig(num_processes=4)
        assert coordinator.spawn_local(cfg, ["-c", script], timeout=30) == 3
        spawn = ("import sys; from repro_torch.launch import coordinator;"
                 f"coordinator.bootstrap(['-c', {script!r},"
                 " '--num-processes', '4'])")
        rc, _, err = _finish(_start([sys.executable, "-c", spawn]))
        assert rc == 3, err

    def test_spawn_local_timeout_is_124(self):
        cfg = coordinator.DistConfig(num_processes=2)
        assert coordinator.spawn_local(
            cfg, ["-c", "import time; time.sleep(60)"], timeout=1) == 124

    def test_run_in_session_kills_the_parent_and_its_ranks(self):
        """A spawn parent with no timeout of its own, whose ranks sleep: at
        the timeout the session goes whole. The ranks hold the output
        pipes, so the call returns at once only if they were killed too."""
        spawn = ("from repro_torch.launch import coordinator;"
                 "coordinator.bootstrap(['-c', 'import time; time.sleep(60)',"
                 " '--num-processes', '2'])")
        t0 = time.monotonic()
        rc, _, _ = coordinator.run_in_session(
            [sys.executable, "-c", spawn], env=_env(), cwd=ROOT, timeout=3)
        assert rc == 124
        assert time.monotonic() - t0 < 30
        assert coordinator.run_in_session(
            [sys.executable, "-c", "print('ok')"], timeout=30)[:2] == (0,
                                                                       "ok\n")


# ------------------------------------------------------- NodeGroup and mesh
def test_node_group_blocks():
    g = nodes.NodeGroup(8, rank=2, world=4)
    assert (g.local, g.first, g.distributed) == (2, 4, True)
    assert g.node_ids("cpu").flatten().tolist() == [4, 5]
    flat = torch.arange(8 * 3)
    assert torch.equal(g.rows(flat), flat.reshape(8, 3)[4:6])
    one = nodes.NodeGroup(4)
    assert (one.local, one.first, one.distributed) == (4, 0, False)
    with pytest.raises(ValueError, match="evenly"):
        nodes.NodeGroup(6, rank=0, world=4)
    with pytest.raises(ValueError, match="out of range"):
        nodes.NodeGroup(8, rank=4, world=4)
    assert nodes.group_of(None, 4) == one
    with pytest.raises(ValueError, match="over 8 nodes"):
        nodes.group_of(g, 4)
    assert nodes.group_of_rows(g, 2) is g
    with pytest.raises(ValueError, match="node rows"):
        nodes.group_of_rows(g, 8)


def test_single_process_mesh():
    assert mesh.global_nodes(4) == nodes.NodeGroup(4)
    seed = (3, torch.arange(5))
    assert mesh.replicate(seed, nodes.NodeGroup(4)) is seed
    assert mesh.checksum([torch.arange(5)]) == mesh.checksum(
        [torch.arange(5)])
    assert mesh.checksum([torch.arange(5)]) != mesh.checksum(
        [torch.arange(5, dtype=torch.int32)])


def test_node_log_keeps_the_groups_rows():
    """The drivers' counterpart of ``shard_log_to_mesh``: a rank keeps its
    nodes' ``[P_local, n]`` rows of the flat node-major log."""
    inputs = gang_check.make_inputs("small", 4, CPU)
    g = nodes.NodeGroup(4, rank=1, world=2)
    shard = runner._node_log(inputs.log, g, CPU)
    n = inputs.log.num_records // 4
    for a, b in zip(shard, inputs.log):
        if b is not None:
            assert torch.equal(a, b[2 * n:4 * n].reshape(2, n))


# ------------------------------------------------------------------ the gangs
@pytest.fixture(scope="module")
def gangs(tmp_path_factory):
    """Both gangs of gang_check at once (collectives and every case): rank
    -> arrays, by gang size."""
    root = tmp_path_factory.mktemp("gangs")
    procs = {}
    for ranks, node_counts in GANGS:
        procs[ranks] = _start(
            [sys.executable, str(ROOT / "tools" / "gang_check.py"),
             "--num-processes", str(ranks), "--device", "cpu",
             "--collectives", "--timeout", str(TIMEOUT - 20),
             "--out", str(root / f"n{ranks}"),
             "--nodes", *map(str, node_counts)])
    out = {}
    for ranks, proc in procs.items():
        rc, stdout, stderr = _finish(proc)
        assert rc == 0, f"gang of {ranks} failed:\n{stdout}\n{stderr[-4000:]}"
        out[ranks] = [dict(np.load(root / f"n{ranks}" / f"rank{r}.npz"))
                      for r in range(ranks)]
    return out


@pytest.fixture(scope="module")
def one_process():
    """(inputs, {case: arrays}) of the one-process run at each P."""
    ref = {}
    for p in (4, 8):
        inputs = gang_check.make_inputs("small", p, CPU)
        ref[p] = (inputs, {name: gang_check.result_arrays(
            *gang_check.case_result(name, inputs, p, CPU))
            for name in gang_check.CASES})
    return ref


def _gang_params():
    return [(ranks, p) for ranks, node_counts in GANGS for p in node_counts]


@pytest.mark.parametrize("ranks,p", _gang_params())
def test_gang_collectives_equal_the_one_process_ops(gangs, ranks, p):
    x = gang_check.collective_inputs(p)
    loc = p // ranks
    full = {
        "all_to_all": nodes.all_to_all(x["all_to_all"]),
        "psum": nodes.psum(x["psum"]),
        "psum_scatter": nodes.psum_scatter(x["psum_scatter"]),
        "all_gather": nodes.all_gather(x["all_gather"]),
        "all_gather_unstride": nodes.all_gather_unstride(
            x["all_gather_unstride"]),
        "global_count": torch.tensor(nodes.global_count(x["global_count"]))}
    # psum's int32 sums wrapped
    assert (full["psum"] != x["psum"].to(torch.int64).sum(0)).all()
    for r, got in enumerate(gangs[ranks]):
        rows = slice(r * loc, (r + 1) * loc)
        for name, want in full.items():
            want = want[rows] if name in ("all_to_all",
                                          "psum_scatter") else want
            np.testing.assert_array_equal(
                got[f"P{p}/collective/{name}"], want.numpy(),
                err_msg=f"{name} rank {r} of {ranks}, P={p}")
        assert int(got[f"P{p}/collective/replicate_refused"]) == 1


@pytest.mark.parametrize("name", list(gang_check.CASES))
@pytest.mark.parametrize("ranks,p", _gang_params())
def test_gang_equals_the_one_process_run(gangs, one_process, ranks, p,
                                         name):
    _, ref = one_process[p]
    want = ref[name]
    for r, got in enumerate(gangs[ranks]):
        for field, value in want.items():
            got_v = got[f"P{p}/{name}/{field}"]
            if field == "rho":
                got_v, value = got_v.view(np.int32), value.view(np.int32)
            np.testing.assert_array_equal(
                got_v, value, err_msg=f"{field}, rank {r} of {ranks}")
        stats = [k for k in got if k.startswith(f"P{p}/{name}/stats_")]
        assert len(stats) == (6 if "mapreduce" in name
                              and "combiner" not in name else 0)
        launches = {k for k in got if k.startswith(f"P{p}/{name}/launches_")}
        assert launches and all(int(got[k]) == 0 for k in launches)


@pytest.mark.parametrize("p", (4, 8))
def test_gang_log_path_equals_jax_single_device(gangs, one_process, p):
    inputs, _ = one_process[p]
    cols = {f: getattr(inputs.log, f).numpy()
            for f in ("site_id", "entity_id", "timestamp", "mark")}
    want = jax_single_device(JaxLog(**{k: jnp.asarray(v)
                                       for k, v in cols.items()}),
                             inputs.cfg.num_sites, statistic="B")
    want_bits = np.asarray(want.rho).view(np.int32)
    for ranks, _ in GANGS:
        for name in gang_check.CASES:
            if gang_check.CASES[name]["source"] == "seed":
                continue
            for r, got in enumerate(gangs[ranks]):
                np.testing.assert_array_equal(
                    got[f"P{p}/{name}/rho"].view(np.int32), want_bits,
                    err_msg=f"{name}, rank {r} of {ranks}")


# -------------------------------------------------------------- the launcher
LAUNCH = ["-m", "repro_torch.launch.malstone", "--device", "cpu",
          "--nodes", "4", "--records-per-node", "4096", "--sites", "512",
          "--entities", "4096", "--backend", "mapreduce", "--runs", "1",
          "--check"]


def test_launcher_gangs_check_and_write_one_document(tmp_path):
    bench = tmp_path / "BENCH_gang.json"
    procs = [
        _start([sys.executable, *LAUNCH, "--stream-chunks", "4",
                "--num-processes", "2", "--bench-json", str(bench)]),
        _start([sys.executable, *LAUNCH, "--num-processes", "4"])]
    for ranks, proc in zip((2, 4), procs):
        rc, out, err = _finish(proc)
        assert rc == 0, f"{ranks} ranks:\n{out}\n{err[-4000:]}"
        for r in range(ranks):
            assert (f"[process {r}/{ranks} via 127.0.0.1:" in out
                    and "local of 4 global nodes on cpu" in out)
        assert out.count("--check: rho[") == ranks
        assert "bit-equals the single-device oracle" in out
    doc = json.loads(bench.read_text())
    assert len(doc["results"]) == 1
    assert doc["results"][0]["params"]["num_processes"] == 2
    assert doc["results"][0]["params"]["nodes"] == 4


@pytest.mark.parametrize("flags,message", [
    (["--gen-device"], "--gen-device is single-process"),
    (["--checkpoint-dir", "ck"], "--checkpoint-dir/--inject-faults are"
                                 " single-process"),
    (["--inject-faults", "seed=1"], "--checkpoint-dir/--inject-faults are"
                                    " single-process")])
def test_launcher_refuses_single_process_paths_in_a_gang(flags, message,
                                                         capsys):
    with pytest.raises(SystemExit) as e:
        malstone.main([*LAUNCH[2:], "--stream-chunks", "4",
                       "--num-processes", "2", *flags])
    assert e.value.code == 2
    assert message in capsys.readouterr().err


def test_launcher_refuses_nodes_that_do_not_split():
    with pytest.raises(SystemExit, match="divide evenly"):
        malstone.main([*LAUNCH[2:], "--num-processes", "3"])
