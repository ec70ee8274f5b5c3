"""The port's launcher gate and its BENCH document, on the CPU.

- ``--check`` holds rho, bit for bit, against ``malstone_single_device``
  run on the CPU over the same records: one-shot, ``--stream-chunks``,
  and ``--overlap on|off``; a tampered oracle makes ``main()`` exit 1.
- The argparse refusals of ``repro/launch/malstone.py:192-198``.
- ``--bench-json`` writes a document both validators accept, under the
  JAX launcher's scenario name, parameter keys and shuffle accounting
  (the JAX launcher runs once, in a subprocess, for its document).
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.bench import schema as jax_schema
from repro_torch.bench import schema
from repro_torch.launch import malstone as launcher

ROOT = pathlib.Path(__file__).resolve().parent.parent
TINY = ["--device", "cpu", "--nodes", "2", "--records-per-node", "2048",
        "--sites", "64", "--entities", "256", "--runs", "1"]
CHECK_LINE = "bit-equals the single-device oracle"


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"),
                                         env.get("PYTHONPATH", "")])
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    return env


@pytest.mark.parametrize("flags", [
    (), ("--statistic", "A"), ("--backend", "streams"),
    ("--stream-chunks", "4"),
    ("--stream-chunks", "4", "--backend", "sphere", "--statistic",
     "B-fixed"),
    ("--stream-chunks", "4", "--overlap", "on"),
    ("--stream-chunks", "4", "--overlap", "off"),
    ("--stream-chunks", "2", "--overlap", "on", "--backend",
     "mapreduce_combiner")], ids="-".join)
def test_check_passes(flags, capsys):
    launcher.main(TINY + ["--check", "--capacity-factor", "0.5", *flags])
    text = capsys.readouterr().out
    assert "--check: rho[" in text and CHECK_LINE in text
    if "--overlap" in flags:
        assert f"overlap={flags[flags.index('--overlap') + 1]}]" in text


def _tampered(real):
    """The oracle with one rho bit flipped."""
    def oracle(*args, **kwargs):
        res = real(*args, **kwargs)
        bits = res.rho.view(torch.int32).clone()
        bits.view(-1)[7] ^= 1
        return res._replace(rho=bits.view(torch.float32))
    return oracle


@pytest.mark.parametrize("flags", [(), ("--stream-chunks", "4", "--overlap",
                                        "on")], ids="-".join)
def test_a_tampered_oracle_fails_the_check(flags, monkeypatch, capsys):
    monkeypatch.setattr(launcher, "malstone_single_device",
                        _tampered(launcher.malstone_single_device))
    with pytest.raises(SystemExit) as exit_info:
        launcher.main(TINY + ["--check", *flags])
    # a string code: the interpreter prints it and exits with status 1
    assert str(exit_info.value.code).startswith("--check FAILED: rho ")
    assert CHECK_LINE not in capsys.readouterr().out


def test_a_tampered_oracle_exits_1():
    code = (
        "import sys\n"
        "sys.path.insert(0, 'tests')\n"
        "from test_torch_launch_check import _tampered, TINY\n"
        "from repro_torch.launch import malstone as launcher\n"
        "launcher.malstone_single_device = "
        "_tampered(launcher.malstone_single_device)\n"
        "launcher.main(TINY + ['--check', '--stream-chunks', '2'])\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, env=_env(), cwd=ROOT)
    assert proc.returncode == 1, proc.stderr[-4000:]
    assert "--check FAILED: rho" in proc.stderr


@pytest.mark.parametrize("flags,msg", [
    (("--check", "--gen-device"), "--check compares"),
    (("--overlap", "on"), "pass --stream-chunks"),
    (("--overlap", "off"), "pass --stream-chunks"),
    (("--overlap", "on", "--stream-chunks", "2", "--gen-device"),
     "--gen-device"),
    (("--overlap", "sometimes", "--stream-chunks", "2"), "invalid choice")])
def test_argparse_refusals(flags, msg, capsys):
    with pytest.raises(SystemExit) as exit_info:
        launcher.main(TINY + list(flags))
    assert exit_info.value.code == 2
    assert msg in capsys.readouterr().err


@pytest.fixture(scope="module")
def jax_document(tmp_path_factory):
    """The JAX launcher's document of a streaming mapreduce run."""
    out = tmp_path_factory.mktemp("jax_launch") / "BENCH_jax_launch.json"
    proc = subprocess.run(
        [sys.executable, "-m", "repro.launch.malstone", "--nodes", "2",
         "--records-per-node", "2048", "--sites", "64", "--entities", "256",
         "--runs", "1", "--backend", "mapreduce", "--stream-chunks", "2",
         "--overlap", "on", "--bench-json", str(out)],
        capture_output=True, text=True, timeout=600, env=_env(), cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(out.read_text())


def test_bench_json_matches_the_jax_launcher(jax_document, tmp_path):
    """The acceptance command: exit 0, the check line, and a document
    under JAX's scenario name with JAX's parameter and derived keys."""
    path = tmp_path / "BENCH_x.json"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.malstone", *TINY,
         "--stream-chunks", "2", "--overlap", "on", "--backend",
         "mapreduce", "--check", "--bench-json", str(path)],
        capture_output=True, text=True, timeout=300, env=_env(), cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert CHECK_LINE in proc.stdout and f"wrote {path}" in proc.stdout
    doc = schema.load_document(path)
    jax_schema.validate_document(doc)
    assert doc["name"] == "x" and doc["platform"] == "cpu"
    assert doc["env"] == {"source": "repro_torch.launch.malstone"}
    (got,), (want,) = doc["results"], jax_document["results"]
    assert got["scenario"] == want["scenario"] \
        == "launch_malstone_b_mapreduce_streaming"
    assert got["params"].keys() == want["params"].keys()
    same = set(want["params"]) - {"histogram_impl"}   # other choices
    assert {k: got["params"][k] for k in same} \
        == {k: want["params"][k] for k in same}
    assert got["derived"] == want["derived"]          # same shuffle
    assert got["records"] == want["records"] == 4096
    assert got["iters"] == 1 and got["us_per_call"] > 0


@pytest.mark.parametrize("flags,scenario", [
    ((), "launch_malstone_b_mapreduce_oneshot"),
    (("--gen-device", "--statistic", "B-fixed"),
     "launch_malstone_bfixed_mapreduce_oneshot_gendev"),
    (("--backend", "streams", "--stream-chunks", "2", "--statistic", "A"),
     "launch_malstone_a_streams_streaming")])
def test_bench_json_scenario_names(flags, scenario, tmp_path, capsys):
    path = tmp_path / "BENCH_names.json"
    launcher.main(TINY + ["--bench-json", str(path), *flags])
    doc = schema.load_document(path)
    (row,) = doc["results"]
    assert row["scenario"] == scenario
    assert row["params"]["num_processes"] == 1
    assert row["params"]["gen_device"] == ("--gen-device" in flags)
    derived = row.get("derived")
    if "streams" in flags:
        assert derived is None
    else:
        assert derived["shuffle_overflow"] == 0
        assert derived["shuffle_sent"] == 4096
    samples = np.asarray(row["samples_us"])
    assert samples.shape == (1,) and samples[0] == row["us_per_call"]
