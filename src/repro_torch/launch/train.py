"""Training launcher, the port's ``repro/launch/train.py``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \
        --steps 100 --batch 8 --seq-len 512 [--smoke] [--device cpu]

``--smoke`` swaps in the reduced same-family config so the launcher is
exercisable on the CPU (``--device cpu``; the default is the card, and
without one the launcher raises rather than fall back). The loop is the
fault-tolerant runtime (checkpoint/restart + SPM node doctor); each step
runs eagerly (JAX's launcher jits it). With ``--data malgen`` each batch
is a MalGen shard rendered to bytes, whose sites K6 samples on the card;
each doctor run finalizes MalStone B with K7.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import torch

from repro_torch.common.nodes import resolve_device
from repro_torch.configs import ALIASES, get_config, get_smoke_config
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.malgen import MalGenConfig
from repro_torch.models import steps as S
from repro_torch.optim import AdamWConfig
from repro_torch.runtime import TrainConfig, Trainer


def main(argv=None) -> dict:
    """Parse ``argv`` (the command line if None), train, print JAX's
    lines and return the trainer's report."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(ALIASES))
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--accum", type=int, default=1,
                    help="gradient accumulation microbatches")
    ap.add_argument("--data", default="malgen",
                    choices=("malgen", "synthetic"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    print(f"arch={cfg.name} params={cfg.num_params_total / 1e6:.1f}M "
          f"(active {cfg.num_params_active / 1e6:.1f}M)")

    data = DataConfig(
        source=args.data, vocab_size=min(cfg.vocab_size, 256),
        seq_len=args.seq_len, global_batch=args.batch,
        malgen=MalGenConfig(num_sites=10_000, num_entities=100_000))
    pipe = TokenPipeline(data, device=device)

    def batch_fn(step):
        b = pipe.batch_at(step)
        if cfg.family == "vlm":
            b["patches"] = torch.zeros(
                (args.batch, cfg.num_patches, cfg.d_model),
                dtype=torch.bfloat16, device=device)
        if cfg.is_encoder_decoder:
            b["frames"] = torch.zeros(
                (args.batch, cfg.encoder_seq, cfg.d_model),
                dtype=torch.bfloat16, device=device)
        return b

    opt_cfg = AdamWConfig(lr=args.lr)
    state, _ = S.make_train_state(
        cfg, opt_cfg, generator=torch.Generator(device=device).manual_seed(0),
        device=device)
    if args.accum > 1:
        step_fn = S.make_grad_accum_train_step(
            cfg, opt_cfg, args.accum, total_steps=args.steps)
    else:
        step_fn = S.make_train_step(cfg, opt_cfg, total_steps=args.steps)

    trainer = Trainer(
        TrainConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                    ckpt_dir=args.ckpt_dir),
        step_fn, state, batch_fn, device=device)
    # the trainer holds the state from here: a second reference would keep
    # the first step's parameters and moments alive beside the current
    # ones (for qwen1.5-4b with f32 moments, 36.8 GiB)
    del state
    report = trainer.run()
    losses = [h["loss"] for h in report["history"]]
    print(f"done: steps={report['final_step']} "
          f"loss {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"restarts={report['restarts']} blocklist={report['blocklist']}")
    return report


if __name__ == "__main__":
    main()
