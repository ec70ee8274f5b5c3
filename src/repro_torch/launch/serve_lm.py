"""LM serving launcher: prefill a batch of prompts, decode N tokens.

The port's ``repro/launch/serve_lm.py``:

    PYTHONPATH=src python -m repro_torch.launch.serve_lm --arch llama3-8b \
        --smoke --prompt-len 64 --decode-tokens 16 --batch 4 [--device cpu]

(``repro_torch.launch.serve`` is a deprecation shim for this module, as in
the JAX package; the MalStone query service lives at
``repro_torch.launch.serve_malstone``.) The prompts are drawn from a
seeded ``torch.Generator`` (no threefry is ported: they are not JAX's).
Times are CUDA events on the card, the host clock on the CPU; the decode
loop makes no host sync until it ends.
"""

from __future__ import annotations

import argparse
import time
from typing import NamedTuple, Optional

import torch

from repro_torch.common.nodes import resolve_device
from repro_torch.configs import ALIASES, get_config, get_smoke_config
from repro_torch.models import decoding as D
from repro_torch.models import transformer as T


class Generation(NamedTuple):
    ids: torch.Tensor          # [B, n] int32, the greedy tokens
    cache: object              # the decode cache after the last step
    enc_out: Optional[torch.Tensor]
    step_ms: list              # the prefill's ms, then each decode step's


class _Stamps:
    """Time marks in stream order: CUDA events on the card (read once,
    at the end), the host clock elsewhere."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks = []

    def mark(self) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def intervals_ms(self) -> list:
        if self.cuda:
            torch.cuda.synchronize()
            return [a.elapsed_time(b) for a, b in zip(self.marks,
                                                      self.marks[1:])]
        return [(b - a) * 1e3 for a, b in zip(self.marks, self.marks[1:])]


def greedy(logits: torch.Tensor, cfg) -> torch.Tensor:
    """[B, 1] int32 argmax of the last position over the real vocabulary
    (a padded id is never predicted, as ``lm_loss`` masks them)."""
    return torch.argmax(logits[:, -1, :cfg.vocab_size], dim=-1)[:, None] \
        .to(torch.int32)


def greedy_generate(params, cfg, batch: dict, n: int, max_len: int, *,
                    on_step=None) -> Generation:
    """JAX's serve loop: the fused prefill, then ``n - 1`` greedy decode
    steps, each fed the previous argmax. ``on_step(i, logits, cache)``,
    if given, sees step i's output (0 the prefill's) after its time mark.
    The cache is updated in place (``decoding.decode_step``)."""
    stamps = _Stamps(batch["tokens"].device)
    stamps.mark()
    logits, cache, enc_out = D.prefill(params, cfg, batch, max_len)
    tok = greedy(logits, cfg)
    stamps.mark()
    if on_step is not None:
        on_step(0, logits, cache)
    out = [tok]
    for i in range(1, n):
        logits, cache = D.decode_step(params, cfg, tok, cache,
                                      enc_out=enc_out)
        tok = greedy(logits, cfg)
        stamps.mark()
        if on_step is not None:
            on_step(i, logits, cache)
        out.append(tok)
    return Generation(torch.cat(out, dim=1), cache, enc_out,
                      stamps.intervals_ms())


def prompt_batch(cfg, batch: int, prompt_len: int, device,
                 seed: int = 1) -> dict:
    """Seeded prompts: uniform token ids, and for a VLM or an encoder-
    decoder 0.1 x normal bf16 patches or frames (drawn on the CPU, so
    that every device gets the same batch)."""
    g = torch.Generator().manual_seed(seed)
    out = {"tokens": torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                                   generator=g, dtype=torch.int32)}
    if cfg.family == "vlm":
        out["patches"] = (0.1 * torch.randn(
            (batch, cfg.num_patches, cfg.d_model), generator=g)).to(
            torch.bfloat16)
    if cfg.is_encoder_decoder:
        out["frames"] = (0.1 * torch.randn(
            (batch, cfg.encoder_seq, cfg.d_model), generator=g)).to(
            torch.bfloat16)
    return {k: v.to(device) for k, v in out.items()}


def main(argv=None) -> Generation:
    """Parse ``argv`` (the command line if None), serve, print JAX's
    lines and return the generation."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(ALIASES))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--decode-tokens", type=int, default=16)
    ap.add_argument("--greedy", action="store_true", default=True)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    params, _ = T.init_params(
        cfg, generator=torch.Generator(device=device).manual_seed(0),
        device=device)
    batch = prompt_batch(cfg, args.batch, args.prompt_len, device)
    max_len = args.prompt_len + args.decode_tokens + 8 \
        + (cfg.num_patches if cfg.family == "vlm" else 0)

    with torch.inference_mode():
        gen = greedy_generate(params, cfg, batch, args.decode_tokens,
                              max_len)
    t_prefill = gen.step_ms[0] / 1e3
    t_decode = sum(gen.step_ms[1:]) / 1e3
    print(f"arch={cfg.name} batch={args.batch} prompt={args.prompt_len}")
    print(f"prefill: {t_prefill * 1e3:.1f} ms "
          f"({args.batch * args.prompt_len / t_prefill:.0f} tok/s)")
    per_tok = t_decode / max(args.decode_tokens - 1, 1)
    print(f"decode:  {per_tok * 1e3:.2f} ms/token "
          f"({args.batch / per_tok:.0f} tok/s batch-wide)")
    print(f"first generated ids: {gen.ids[0, :8].tolist()}")
    return gen


if __name__ == "__main__":
    main()
