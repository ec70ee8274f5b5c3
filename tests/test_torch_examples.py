"""The port's examples run on the CPU at a small size, and refuse to run
without a card unless asked for the CPU."""

import importlib.util
import pathlib

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _example(name):
    path = ROOT / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"example_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_quickstart_runs_on_the_cpu(capsys):
    _example("quickstart_torch").main(
        ["--device", "cpu", "--records", "20000", "--sites", "500",
         "--entities", "2000"])
    text = capsys.readouterr().out
    assert "generating 20,000 events for 500 sites (25 marked)" in text
    assert "mean rho over marked sites" in text
    assert "top-10 sites by rho_j" in text
    assert "MalStone B for site" in text


def test_malstone_cloud_matches_the_oracle_on_the_cpu(capsys):
    matches = _example("malstone_cloud_torch").main(
        ["--device", "cpu", "--nodes", "4", "--records-per-node", "4096",
         "--sites", "512", "--entities", "4096"])
    assert matches == [True] * 6
    text = capsys.readouterr().out
    for backend in ("streams", "sphere", "mapreduce"):
        assert text.count(f"\n{backend:<12} ") == 2


def test_node_doctor_prints_what_the_jax_example_prints(capsys):
    """The same telemetry, the same table, the same suspects and the same
    final check (host 11 alone alarms). On this telemetry the check fails
    in both: host 1's CUSUM peaks at 6.31, over the threshold of 6, so
    both examples refuse, naming the same hosts."""
    import runpy

    with pytest.raises(AssertionError):
        runpy.run_path(str(ROOT / "examples" / "node_doctor.py"),
                       run_name="__main__")
    want = capsys.readouterr().out
    with pytest.raises(SystemExit, match=r"got \[1, 11\]"):
        _example("node_doctor_torch").main(["--device", "cpu"])
    got = capsys.readouterr().out
    assert got == want
    assert got.count("<-- blocklist") == 2
    assert "top suspects: [11, 8, 2] (truth: 11)" in got


@pytest.mark.parametrize("name", ("quickstart_torch",
                                  "malstone_cloud_torch",
                                  "node_doctor_torch"))
def test_examples_refuse_to_fall_back_to_the_cpu(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _example(name).main([])
