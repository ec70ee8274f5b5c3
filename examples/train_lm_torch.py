"""End-to-end driver: train an LM on MalGen log data with the fault-tolerant
runtime (checkpoints, retries, SPM node doctor), on the port.

The PyTorch counterpart of ``examples/train_lm.py``. Default is a
CPU-sized model so the example runs anywhere (``--device cpu``; the
default device is the card); ``--full`` trains a ~100M-param llama-style
model for a few hundred steps.

    PYTHONPATH=src python examples/train_lm_torch.py --device cpu \
        [--steps 30] [--full]
"""

import argparse
import os
import tempfile

import torch

from repro_torch.common.nodes import resolve_device
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.malgen import MalGenConfig
from repro_torch.models import steps as S
from repro_torch.models.config import ModelConfig
from repro_torch.optim import AdamWConfig
from repro_torch.runtime import TrainConfig, Trainer


def small_config():
    return ModelConfig(
        name="malstone-lm-12m", family="dense", num_layers=4,
        d_model=256, num_heads=8, num_kv_heads=4, d_ff=1024,
        vocab_size=256, layer_pattern=("attn",), mlp_pattern=("swiglu",))


def full_config():
    # ~100M params: 12L x 768 with byte vocab
    return ModelConfig(
        name="malstone-lm-100m", family="dense", num_layers=12,
        d_model=768, num_heads=12, num_kv_heads=4, d_ff=3072,
        vocab_size=256, layer_pattern=("attn",), mlp_pattern=("swiglu",))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_train_lm"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = full_config() if args.full else small_config()
    print(f"model: {cfg.name} ({cfg.num_params_total / 1e6:.1f}M params)")

    data = DataConfig(source="malgen", vocab_size=cfg.vocab_size,
                      seq_len=args.seq_len, global_batch=args.batch,
                      malgen=MalGenConfig(num_sites=10_000,
                                          num_entities=100_000))
    pipe = TokenPipeline(data, device=device)

    opt_cfg = AdamWConfig(lr=3e-4, weight_decay=0.01)
    state, _ = S.make_train_state(
        cfg, opt_cfg, generator=torch.Generator(device=device).manual_seed(0),
        device=device)
    step_fn = S.make_train_step(cfg, opt_cfg, warmup_steps=10,
                                total_steps=args.steps)

    tcfg = TrainConfig(total_steps=args.steps, ckpt_every=10,
                       ckpt_dir=args.ckpt_dir)
    trainer = Trainer(tcfg, step_fn, state, pipe.batch_at, device=device)
    del state          # the trainer holds it (and drops it after a step)
    report = trainer.run()

    losses = [h["loss"] for h in report["history"]]
    print(f"\ntrained {report['final_step']} steps on MalGen log bytes")
    print(f"loss: first={losses[0]:.3f} last={losses[-1]:.3f} "
          f"(restarts={report['restarts']}, retries={report['retries']})")
    if not losses[-1] < losses[0]:
        raise SystemExit("loss should decrease")
    return report


if __name__ == "__main__":
    main()
