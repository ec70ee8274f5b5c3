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


@pytest.mark.parametrize("name", ("quickstart_torch",
                                  "malstone_cloud_torch"))
def test_examples_refuse_to_fall_back_to_the_cpu(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _example(name).main([])
