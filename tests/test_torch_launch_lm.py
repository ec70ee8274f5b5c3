"""The port's language-model launchers and example on the CPU, against
the JAX package's printed lines, and ``TrainState`` checkpoints crossing
between the packages.

Each launcher runs at the smoke configs (``--smoke --device cpu``), and
its lines are held against the JAX launcher's with every number blanked:
the same words, fields and order. Without ``--device cpu`` and without a
card each entry point raises instead of running on the CPU.
"""

import importlib
import os
import pathlib
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.common.tree import tree_flatten_with_paths as jax_flatten
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import steps as jax_S
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.runtime import TrainConfig as JaxTrainConfig
from repro.runtime import Trainer as JaxTrainer
from test_torch_examples import _example

from repro_torch.checkpoint import CheckpointManager
from repro_torch.common.tree import tree_flatten_with_paths
from repro_torch.configs import get_smoke_config
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.launch import serve_lm, train
from repro_torch.models import steps as S
from repro_torch.optim import AdamWConfig
from repro_torch.runtime import TrainConfig, Trainer

ROOT = pathlib.Path(__file__).resolve().parent.parent
NUM = re.compile(r"-?\d+(\.\d+)?(e[-+]\d+)?")
SERVE = ["--arch", "llama3-8b", "--smoke", "--batch", "2", "--prompt-len",
         "12", "--decode-tokens", "5"]
TRAIN = ["--arch", "gemma2-2b", "--smoke", "--steps", "3", "--batch", "2",
         "--seq-len", "32", "--ckpt-every", "100"]


def _template(text: str) -> list:
    return [NUM.sub("#", line) for line in text.strip().splitlines()]


def _jax_main(module, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["prog"] + argv)
    module.main()


def test_serve_lm_prints_jax_lines(capsys, monkeypatch):
    from repro.launch import serve_lm as jax_serve_lm

    gen = serve_lm.main(SERVE + ["--device", "cpu"])
    got = capsys.readouterr().out
    _jax_main(jax_serve_lm, SERVE, monkeypatch)
    want = capsys.readouterr().out
    assert _template(got) == _template(want)
    assert got.splitlines()[0] == want.splitlines()[0]
    cfg = get_smoke_config("llama3_8b")
    assert gen.ids.shape == (2, 5) and gen.ids.dtype == torch.int32
    # the greedy choice never takes a padded id (JAX's launcher may)
    assert int(gen.ids.min()) >= 0 and int(gen.ids.max()) < cfg.vocab_size
    assert len(gen.step_ms) == 5 and min(gen.step_ms) > 0
    assert int(gen.cache[0]["kind_attn"].length[0]) == 12 + 4


def test_greedy_generate_is_prefill_then_decode_steps():
    """The launcher's loop equals the fused prefill and decode steps
    called by hand, and ``on_step`` sees every step's output."""
    from repro_torch.models import decoding as D
    from repro_torch.models import transformer as T

    cfg = get_smoke_config("recurrentgemma_2b")
    p, _ = T.init_params(cfg, device="cpu")
    batch = serve_lm.prompt_batch(cfg, 2, 20, "cpu")
    seen = []
    gen = serve_lm.greedy_generate(p, cfg, batch, 4, 30,
                                   on_step=lambda i, lg, c: seen.append(i))
    assert seen == [0, 1, 2, 3]
    logits, cache, _ = D.prefill(p, cfg, batch, 30)
    toks = [serve_lm.greedy(logits, cfg)]
    for _ in range(3):
        logits, cache = D.decode_step(p, cfg, toks[-1], cache)
        toks.append(serve_lm.greedy(logits, cfg))
    assert torch.equal(gen.ids, torch.cat(toks, dim=1))


def test_train_launcher_prints_jax_lines(capsys, monkeypatch, tmp_path):
    from repro.launch import train as jax_train

    report = train.main(TRAIN + ["--device", "cpu", "--ckpt-dir",
                                 str(tmp_path / "port")])
    got = capsys.readouterr().out
    _jax_main(jax_train, TRAIN + ["--ckpt-dir", str(tmp_path / "jax")],
              monkeypatch)
    want = capsys.readouterr().out
    assert _template(got) == _template(want)
    assert got.splitlines()[0] == want.splitlines()[0]
    assert report["final_step"] == 3 and len(report["history"]) == 3
    assert all(np.isfinite(h["loss"]) for h in report["history"])
    assert not list((tmp_path / "port").glob("step_*"))


def test_train_launcher_accumulates_and_takes_synthetic_data(capsys,
                                                              tmp_path):
    report = train.main(["--arch", "whisper-small", "--smoke", "--steps",
                         "2", "--batch", "2", "--seq-len", "16", "--accum",
                         "2", "--data", "synthetic", "--device", "cpu",
                         "--ckpt-dir", str(tmp_path), "--ckpt-every", "1"])
    out = capsys.readouterr().out
    assert out.splitlines()[-1].startswith("done: steps=2 loss ")
    assert report["final_step"] == 2
    assert sorted(p.name for p in tmp_path.glob("step_*.COMMITTED")) == [
        "step_00000000.COMMITTED", "step_00000001.COMMITTED"]


def test_train_lm_example_runs_on_the_cpu(capsys, tmp_path):
    report = _example("train_lm_torch").main(
        ["--device", "cpu", "--steps", "12", "--batch", "4", "--seq-len",
         "64", "--ckpt-dir", str(tmp_path)])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "model: malstone-lm-12m (4.1M params)"
    assert lines[-2] == "trained 12 steps on MalGen log bytes"
    assert re.fullmatch(r"loss: first=\d+\.\d{3} last=\d+\.\d{3} "
                        r"\(restarts=0, retries=0\)", lines[-1])
    losses = [h["loss"] for h in report["history"]]
    assert losses[-1] < losses[0]


def test_lm_entry_points_refuse_to_fall_back_to_the_cpu(monkeypatch,
                                                         tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [lambda: serve_lm.main(SERVE),
             lambda: train.main(TRAIN + ["--ckpt-dir", str(tmp_path)]),
             lambda: _example("train_lm_torch").main(
                 ["--steps", "1", "--ckpt-dir", str(tmp_path)]),
             lambda: S.make_train_state(get_smoke_config("llama3_8b"),
                                        AdamWConfig())]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert not list(tmp_path.iterdir())


def test_lm_launchers_exit_non_zero_without_a_card(tmp_path):
    """Run as programs with every card hidden, the launchers exit
    non-zero, naming ``device='cpu'``, and write nothing."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=str(ROOT / "src"))
    for argv in (["-m", "repro_torch.launch.serve_lm", *SERVE],
                 ["-m", "repro_torch.launch.train", *TRAIN, "--ckpt-dir",
                  str(tmp_path / "ck")]):
        out = subprocess.run([sys.executable, *argv], env=env, cwd=ROOT,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert "device='cpu'" in out.stderr
    assert not list(tmp_path.iterdir())


def test_serve_shim_warns():
    sys.modules.pop("repro_torch.launch.serve", None)
    with pytest.warns(DeprecationWarning, match="serve_lm"):
        shim = importlib.import_module("repro_torch.launch.serve")
    assert shim.main is serve_lm.main


# ------------------------------------------------------------ checkpoints

ARCH = "llama3_8b"
OPT = dict(lr=1e-3)


def _batches(n):
    pipe = TokenPipeline(DataConfig(global_batch=2, seq_len=16, seed=5),
                         device="cpu")
    return [pipe.batch_at(i) for i in range(n)]


def _port_state():
    state, _ = S.make_train_state(get_smoke_config(ARCH), AdamWConfig(**OPT),
                                  device="cpu")
    return state


def _jax_state():
    state, _ = jax_S.make_train_state(jax.random.key(0),
                                      jax_smoke_config(ARCH),
                                      JaxAdamWConfig(**OPT))
    return state


def _same_leaves(got, want):
    """Leaf names equal, values bit-equal (bf16 leaves as their f32
    values)."""
    got = tree_flatten_with_paths(got)
    want = jax_flatten(want)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, g), (_, w) in zip(got, want):
        w = np.asarray(w)
        assert str(g.dtype).split(".")[1] == w.dtype.name, name
        if g.dtype == torch.bfloat16:
            g, w = g.to(torch.float32), w.astype(np.float32)
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


def test_train_state_checkpoint_crosses_to_jax(tmp_path):
    """The port's trainer writes a bf16 ``TrainState`` after 2 steps;
    JAX's ``CheckpointManager`` restores it into ``make_train_state``'s
    structure with the same leaf names and bits."""
    batches = _batches(2)
    tr = Trainer(TrainConfig(total_steps=2, ckpt_every=2,
                             ckpt_dir=str(tmp_path)),
                 S.make_train_step(get_smoke_config(ARCH),
                                   AdamWConfig(**OPT)),
                 _port_state(), lambda s: batches[s], device="cpu")
    tr.run()
    step, restored = JaxCheckpointManager(str(tmp_path)).restore_latest(
        _jax_state())
    assert step == 1
    assert int(restored.opt.step) == 2
    _same_leaves(tr.state, restored)


def test_train_state_checkpoint_crosses_from_jax(tmp_path):
    """JAX's trainer writes its ``TrainState`` after 2 steps; the port's
    ``CheckpointManager`` restores it into ``make_train_state``'s
    structure, and the port's trainer resumes from it."""
    batches = [{k: jax.numpy.asarray(v.numpy()) for k, v in b.items()}
               for b in _batches(3)]
    jtr = JaxTrainer(JaxTrainConfig(total_steps=2, ckpt_every=2,
                                    ckpt_dir=str(tmp_path)),
                     jax.jit(jax_S.make_train_step(
                         jax_smoke_config(ARCH), JaxAdamWConfig(**OPT))),
                     _jax_state(), lambda s: batches[s])
    jtr.run()
    step, restored = CheckpointManager(str(tmp_path)).restore_latest(
        _port_state())
    assert step == 1 and restored.opt.step.dtype == torch.int32
    _same_leaves(restored, jtr.state)
    port_batches = _batches(3)
    tr = Trainer(TrainConfig(total_steps=3, ckpt_every=100,
                             ckpt_dir=str(tmp_path)),
                 S.make_train_step(get_smoke_config(ARCH),
                                   AdamWConfig(**OPT)),
                 _port_state(), lambda s: port_batches[s], device="cpu")
    report = tr.run()
    assert [h["step"] for h in report["history"]] == [2]
    assert int(tr.state.opt.step) == 3
