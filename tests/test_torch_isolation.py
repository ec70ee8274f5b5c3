"""The port stands alone: it imports neither JAX nor the JAX package, it
never runs on the CPU unless asked to, and its launcher runs a small job
on the CPU when asked to."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro_torch.core import malstone_run, run
from repro_torch.malgen import MalGenConfig, generate_shards_device, make_seed

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"] + sorted((ROOT / "tools").glob("*.py")) + sorted(
    (ROOT / "examples").glob("*_torch.py"))


def _imported_roots(path: pathlib.Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_the_jax_package(path):
    bad = _imported_roots(path) & {"jax", "jaxlib", "repro"}
    assert not bad, f"{path} imports {sorted(bad)}"


def test_port_has_no_bare_asserts():
    """The LN001 rule of the port's own ``repro_torch.analysis.lint``,
    over the port (its analysis package included)."""
    from repro_torch.analysis.lint import iter_bare_asserts

    assert iter_bare_asserts(ROOT / "src" / "repro_torch") == []


def test_entry_points_refuse_to_fall_back_to_the_cpu(monkeypatch):
    """With no CUDA device and no device="cpu", every entry point raises
    instead of quietly running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = MalGenConfig(num_sites=64, num_entities=128)
    seed = make_seed(1, cfg, 256, device="cpu")
    log = generate_shards_device(seed, cfg, 2, 128, device="cpu").map(
        lambda c: c.reshape(-1))
    calls = [
        lambda: make_seed(1, cfg, 256),
        lambda: generate_shards_device(seed, cfg, 2, 128),
        lambda: malstone_run(log, 64, nodes=2),
        lambda: run(log, 64, nodes=2),
        lambda: run(seed, engine="generated", nodes=2, cfg=cfg,
                    records_per_shard=128),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_streaming_and_service_refuse_to_fall_back_to_the_cpu(monkeypatch):
    """The streaming drivers, the streaming seed and the query service run
    on the card unless device="cpu" is passed; without a card they
    raise."""
    from repro_torch.malgen import make_seed_streaming
    from repro_torch.serve import MalStoneService

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = MalGenConfig(num_sites=64, num_entities=128)
    seed = make_seed_streaming(1, cfg, 4, 64, device="cpu")
    calls = [
        lambda: make_seed_streaming(1, cfg, 4, 64),
        lambda: run(seed, engine="streaming", nodes=2, cfg=cfg,
                    num_chunks=4, chunk_records=64),
        lambda: run(make_seed(1, cfg, 256, device="cpu"),
                    engine="generated_streaming", nodes=2, cfg=cfg,
                    records_per_shard=128, chunk_records=64),
        lambda: MalStoneService(nodes=2, num_sites=64, chunk_records=64),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_bench_refuses_to_fall_back_to_the_cpu(monkeypatch):
    """The bench context and its CLI run on the card unless asked for the
    CPU; without a card they raise."""
    from repro_torch.bench import registry
    from repro_torch.bench import run as bench_run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [
        lambda: registry.BenchContext(),
        lambda: registry.BenchContext(nodes=8, device="cuda"),
        lambda: bench_run.main(["--scenario",
                                "kernel_windowed_ratio_pallas"]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_model_entry_points_refuse_to_fall_back_to_the_cpu(monkeypatch):
    """init_params, params_from_numpy, LanguageModel and the caches run on
    the card unless the caller passes device="cpu" (or "meta"); without a
    card they raise. forward runs where its parameters are, so a forward
    without a card is refused where its parameters are made."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import attention as A
    from repro_torch.models import transformer as T
    from repro_torch.models.convert import params_from_numpy, params_to_numpy

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke_config("llama3_8b")
    flat = params_to_numpy(T.init_params(cfg, device="cpu")[0])
    batch = {"tokens": torch.zeros((1, 4), dtype=torch.int32)}
    calls = [
        lambda: T.init_params(cfg),
        lambda: T.init_params(cfg, device="cuda"),
        lambda: T.forward(T.init_params(cfg)[0], cfg, batch),
        lambda: T.LanguageModel(cfg),
        lambda: T.LanguageModel(cfg)(batch),
        lambda: params_from_numpy(flat, cfg),
        lambda: A.empty_cache(1, 8, 2, 16),
        lambda: A.empty_ring_cache(1, 8, 2, 16),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert T.forward(params_from_numpy(flat, cfg, device="cpu"), cfg,
                     batch).shape == (1, 4, cfg.padded_vocab)
    assert T.init_params(cfg, device="meta")[0]["embed"]["table"].is_meta


def test_launcher_runs_a_tiny_job_on_the_cpu():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"),
                                         env.get("PYTHONPATH", "")])
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.malstone", "--device",
         "cpu", "--nodes", "2", "--records-per-node", "4096", "--sites",
         "512", "--entities", "4096", "--runs", "1", "--gen-device",
         "--histogram-impl", "kernel", "--capacity-factor", "0.5"],
        capture_output=True, text=True, timeout=120, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "records/s" in proc.stdout
    assert "overflow=0" in proc.stdout
