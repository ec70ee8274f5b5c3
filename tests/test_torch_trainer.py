"""The port's fault-tolerant trainer against the JAX package's.

The five trainer tests of ``tests/test_runtime.py`` run on the port with a
one-parameter toy step. Then both trainers run the same scenarios on the
same tokens (JAX's batches handed to the port) under one deterministic
clock: ``time.monotonic`` in each trainer module is replaced by a counter
that adds 2^-10 s a call, so every duration is exactly equal and the
straggler test cannot tell the packages apart by their real speed. The
reports must then be equal: history steps and hosts, retries, restarts,
final step and blocklist exactly (NodeDoctor's report equals JAX's bit for
bit), losses to ``rtol=1e-6``. Last, a checkpoint crosses: one package's
trainer "crashes" at step 20 and the other's resumes it.
"""

import itertools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import DataConfig as JaxDataConfig
from repro.data import TokenPipeline as JaxTokenPipeline
from repro.runtime import TrainConfig as JaxTrainConfig
from repro.runtime import Trainer as JaxTrainer
from repro.runtime import trainer as jax_trainer_mod
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.runtime import TrainConfig, Trainer
from repro_torch.runtime import trainer as trainer_mod


def toy_step(state, batch):
    """The port's one-parameter model of ``tests/test_runtime.py``."""
    w, opt_step = state
    x = batch["tokens"].to(torch.float32)
    loss = torch.mean((x.mean() - w) ** 2)
    w = w - 0.1 * 2 * (w - x.mean())
    return (w, opt_step + 1), {"loss": loss}


def jax_toy_step(state, batch):
    w, opt_step = state
    x = batch["tokens"].astype(jnp.float32)
    loss = jnp.mean((x.mean() - w) ** 2)
    w = w - 0.1 * 2 * (w - x.mean())
    return (w, opt_step + 1), {"loss": loss}


def tiny_setup(tmp_path, total_steps=40, ckpt_every=10, fault_hook=None,
               doctor_every=10):
    pipe = TokenPipeline(DataConfig(global_batch=4, seq_len=16, seed=3),
                         device="cpu")
    cfg = TrainConfig(total_steps=total_steps, ckpt_every=ckpt_every,
                      ckpt_dir=str(tmp_path / "ckpt"),
                      doctor_every=doctor_every)
    state = (torch.zeros(()), torch.zeros((), dtype=torch.int32))
    return Trainer(cfg, toy_step, state, pipe.batch_at,
                   fault_hook=fault_hook, device="cpu"), cfg


def test_runs_to_completion(tmp_path):
    tr, cfg = tiny_setup(tmp_path)
    report = tr.run()
    assert report["final_step"] == cfg.total_steps
    assert len(report["history"]) == cfg.total_steps
    assert report["restarts"] == 0


def test_transient_fault_retried(tmp_path):
    seen = set()

    def hook(step, host):
        if step == 7 and 7 not in seen:
            seen.add(7)
            raise RuntimeError("injected transient fault")

    tr, cfg = tiny_setup(tmp_path, fault_hook=hook)
    report = tr.run()
    assert report["final_step"] == cfg.total_steps
    assert report["retries"] >= 1
    assert report["restarts"] == 0


def test_persistent_fault_restores_from_checkpoint(tmp_path):
    calls = {"n": 0}

    def hook(step, host):
        # step 25 fails 3 times (more than max_retries) once, then heals
        if step == 25 and calls["n"] < 4:
            calls["n"] += 1
            raise RuntimeError("injected persistent fault")

    tr, cfg = tiny_setup(tmp_path, fault_hook=hook)
    report = tr.run()
    assert report["final_step"] == cfg.total_steps
    assert report["restarts"] >= 1   # restored from step 19's checkpoint


def test_crash_resume_from_disk(tmp_path):
    """A full process crash: a new Trainer resumes at the last committed
    checkpoint, not from scratch."""
    tr1, cfg = tiny_setup(tmp_path, total_steps=25, ckpt_every=10)
    tr1.cfg.total_steps = 20
    tr1.run()
    tr2, _ = tiny_setup(tmp_path, total_steps=25, ckpt_every=10)
    start = tr2.resume_if_possible()
    assert start == 20  # checkpoint at step 19 -> resume at 20
    report = tr2.run()
    assert report["final_step"] == 25


def test_bad_host_blocklisted_by_spm_doctor(tmp_path):
    """A host that fails its steps is attributed by MalStone B + CUSUM
    and lands on the blocklist; its steps are then reassigned."""
    def hook(step, host):
        if host == 5 and step > 8:
            raise RuntimeError("flaky host 5")

    tr, cfg = tiny_setup(tmp_path, total_steps=80, ckpt_every=10,
                         doctor_every=8, fault_hook=hook)
    report = tr.run()
    assert report["final_step"] == cfg.total_steps
    assert 5 in report["blocklist"], report["blocklist"]
    tail_hosts = {h["host"] for h in report["history"][-16:]}
    assert 5 not in tail_hosts


def test_trainer_refuses_to_fall_back_to_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TrainConfig(ckpt_dir=str(tmp_path / "c"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(cfg, toy_step, (torch.zeros(()),), lambda s: {})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TokenPipeline(DataConfig())


# -- against JAX, under one deterministic clock ---------------------------

def _fake_time():
    """A monotonic clock that adds 2^-10 s a call (durations exact)."""
    counter = itertools.count()
    return types.SimpleNamespace(monotonic=lambda: next(counter) / 1024.0)


@pytest.fixture
def fake_clocks(monkeypatch):
    def install():
        monkeypatch.setattr(jax_trainer_mod, "time", _fake_time())
        monkeypatch.setattr(trainer_mod, "time", _fake_time())
    return install


class JaxBatches:
    """JAX's synthetic batches, computed once a step, for both trainers."""

    def __init__(self, total_steps):
        pipe = JaxTokenPipeline(JaxDataConfig(global_batch=4, seq_len=16,
                                              seed=3))
        self.jax = [pipe.batch_at(s) for s in range(total_steps)]
        self.torch = [{k: torch.from_numpy(np.array(v)) for k, v in b.items()}
                      for b in self.jax]


_BATCHES = {}


def _batches(total):
    if total not in _BATCHES:
        _BATCHES[total] = JaxBatches(total)
    return _BATCHES[total]


def _hooks(name):
    """A fresh fault hook of each scenario (each keeps its own state)."""
    if name == "fault_free":
        return None
    if name == "transient":
        seen = set()

        def hook(step, host):
            if step == 7 and 7 not in seen:
                seen.add(7)
                raise RuntimeError("injected transient fault")
        return hook
    if name == "persistent":
        calls = {"n": 0}

        def hook(step, host):
            if step == 25 and calls["n"] < 4:
                calls["n"] += 1
                raise RuntimeError("injected persistent fault")
        return hook

    def hook(step, host):
        if host == 5 and step > 8:
            raise RuntimeError("flaky host 5")
    return hook


SCENARIOS = {"fault_free": dict(total_steps=40, doctor_every=10),
             "transient": dict(total_steps=40, doctor_every=10),
             "persistent": dict(total_steps=40, doctor_every=10),
             "bad_host": dict(total_steps=80, doctor_every=8)}


def _jax_trainer(tmp_path, sub, batches, hook=None, **kw):
    cfg = JaxTrainConfig(ckpt_every=10, ckpt_dir=str(tmp_path / sub), **kw)
    state = (jnp.zeros(()), jnp.zeros((), jnp.int32))
    return JaxTrainer(cfg, jax.jit(jax_toy_step), state,
                      lambda s: batches.jax[s], fault_hook=hook)


def _port_trainer(tmp_path, sub, batches, hook=None, **kw):
    cfg = TrainConfig(ckpt_every=10, ckpt_dir=str(tmp_path / sub), **kw)
    state = (torch.zeros(()), torch.zeros((), dtype=torch.int32))
    return Trainer(cfg, toy_step, state, lambda s: batches.torch[s],
                   fault_hook=hook, device="cpu")


def _assert_same_report(got, want):
    for key in ("final_step", "restarts", "retries", "blocklist"):
        assert got[key] == want[key], key
    assert [(h["step"], h["host"]) for h in got["history"]] == [
        (h["step"], h["host"]) for h in want["history"]]
    np.testing.assert_allclose([h["loss"] for h in got["history"]],
                               [h["loss"] for h in want["history"]],
                               rtol=1e-6)
    assert [h["dur"] for h in got["history"]] == [
        h["dur"] for h in want["history"]]


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_report_equals_jax_under_a_deterministic_clock(tmp_path, fake_clocks,
                                                       name):
    kw = SCENARIOS[name]
    batches = _batches(kw["total_steps"])
    fake_clocks()
    want = _jax_trainer(tmp_path, "jax", batches, _hooks(name), **kw).run()
    got = _port_trainer(tmp_path, "port", batches, _hooks(name), **kw).run()
    _assert_same_report(got, want)
    if name == "bad_host":
        assert 5 in got["blocklist"]
        assert got["restarts"] >= 1 and got["retries"] >= 3
    diff = np.abs(np.array([h["loss"] for h in got["history"]])
                  - np.array([h["loss"] for h in want["history"]]))
    print(f"{name}: max |port - JAX| loss {diff.max()}")


@pytest.mark.parametrize("crashes,resumes", [("jax", "port"),
                                             ("port", "jax")])
def test_checkpoint_crosses_between_packages(tmp_path, fake_clocks, crashes,
                                             resumes):
    """One package's trainer runs 20 steps and stops ("crashes"); the
    other's resumes from its checkpoint at 20 and finishes 25 with the
    steps 20-24 of an uninterrupted run of the resuming package."""
    batches = _batches(25)
    make = {"jax": _jax_trainer, "port": _port_trainer}
    fake_clocks()
    first = make[crashes](tmp_path, "shared", batches, total_steps=25)
    first.cfg.total_steps = 20
    first.run()
    second = make[resumes](tmp_path, "shared", batches, total_steps=25)
    assert second.resume_if_possible() == 20
    report = second.run()
    assert report["final_step"] == 25
    whole = make[resumes](tmp_path, "whole", batches, total_steps=25).run()
    tail = [h for h in whole["history"] if h["step"] >= 20]
    assert [(h["step"], h["host"]) for h in report["history"]] == [
        (h["step"], h["host"]) for h in tail]
    np.testing.assert_allclose([h["loss"] for h in report["history"]],
                               [h["loss"] for h in tail], rtol=1e-6)
    # the restored state has the resuming package's leaf dtypes
    w, opt_step = second.state
    if resumes == "port":
        assert w.dtype == torch.float32 and opt_step.dtype == torch.int32
    else:
        assert w.dtype == jnp.float32 and opt_step.dtype == jnp.int32
    assert int(opt_step) == 25
