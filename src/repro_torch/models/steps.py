"""Step builders: the train / prefill / decode entry points that the
runtime trainer and the serving launcher call.

Counterpart of ``repro/models/steps.py``. A step is a plain function on
tensors (no compilation: every step runs eagerly on the device its
parameters live on). The train step is functional like JAX's: it returns
a new ``TrainState`` and leaves its input alone, so the trainer can retry
a failed step from the state it holds; the decode step consumes its cache
(``decoding.decode_step``).

``input_specs(cfg, shape_name)`` produces ``meta`` tensors standing for
every model input of an assigned (arch x input-shape) cell: shapes and
dtypes, no allocation (JAX's ``ShapeDtypeStruct`` and ``eval_shape``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import torch

from repro_torch.common import tree as tr
from repro_torch.models import decoding as D
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.optim import AdamWConfig, OptState, adamw_init, adamw_update
from repro_torch.optim.schedule import linear_warmup_cosine

META = torch.device("meta")


# --------------------------------------------------------------------------
# Assigned input shapes (LM-family: seq_len x global_batch)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    kind: str          # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": InputShape("train_4k", "train", 4096, 256),
    "prefill_32k": InputShape("prefill_32k", "prefill", 32768, 32),
    "decode_32k": InputShape("decode_32k", "decode", 32768, 128),
    "long_500k": InputShape("long_500k", "decode", 524288, 1),
}


def shape_applicable(cfg: ModelConfig, shape_name: str) -> tuple[bool, str]:
    """(applicable, reason-if-not). The long_500k skip rule lives here."""
    if shape_name == "long_500k" and not cfg.supports_long_context:
        return False, ("global full-attention layers: 512k decode KV state "
                       "is the blocker per the shape spec (run only for "
                       "SSM/hybrid/windowed archs)")
    return True, ""


# --------------------------------------------------------------------------
# Train step
# --------------------------------------------------------------------------

class TrainState(NamedTuple):
    params: Any
    opt: OptState


def make_train_state(cfg: ModelConfig, opt_cfg: AdamWConfig, *,
                     generator: Optional[torch.Generator] = None,
                     device=None):
    """``(TrainState, axes)``: ``init_params``'s parameters on ``device``
    (the card unless the caller asks for the CPU) from ``generator``, and
    fresh AdamW moments."""
    params, axes = T.init_params(cfg, generator=generator, device=device)
    return TrainState(params=params, opt=adamw_init(params, opt_cfg)), axes


def loss_and_grads(params, cfg: ModelConfig, batch: dict):
    """``(loss, metrics, grads)`` of ``lm_loss`` at ``params`` (JAX's
    ``value_and_grad(..., has_aux=True)``): the loss and metrics detached,
    the gradients a list of leaves in flattening order, each in its
    parameter's dtype (zeros for a leaf the loss does not reach, as JAX
    gives)."""
    leaves = [x.detach().requires_grad_(True)
              for x in tr.tree_leaves(params)]
    with torch.enable_grad():
        loss, metrics = T.lm_loss(tr.tree_unflatten(params, leaves), cfg,
                                  batch)
        grads = list(torch.autograd.grad(loss, leaves, allow_unused=True,
                                         materialize_grads=True))
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    warmup_steps: int = 100, total_steps: int = 10_000):
    """``(state, batch) -> (state, metrics)``: one gradient of ``lm_loss``
    and one AdamW update at the warmup-cosine scale of the step. Nothing
    in it waits for the device."""

    def train_step(state: TrainState, batch: dict):
        _, metrics, grads = loss_and_grads(state.params, cfg, batch)
        lr_scale = linear_warmup_cosine(state.opt.step + 1, warmup_steps,
                                        total_steps)
        new_params, new_opt, om = adamw_update(
            state.params, grads, state.opt, opt_cfg, lr_scale,
            consume_grads=True)
        return TrainState(new_params, new_opt), {**metrics, **om}

    return train_step


def make_grad_accum_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                               accum_steps: int,
                               warmup_steps: int = 100,
                               total_steps: int = 10_000):
    """Micro-batched step: a loop over ``accum_steps`` slices of the
    batch's leading dim, each gradient divided by ``accum_steps`` and added
    into f32 zeros, then a single optimizer update; ``loss`` is the mean
    of the micro losses."""

    def train_step(state: TrainState, batch: dict):
        def micro(i):
            return {k: x.reshape(accum_steps, -1, *x.shape[1:])[i]
                    for k, x in batch.items()}

        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in tr.tree_leaves(state.params)]
        losses = []
        for i in range(accum_steps):
            loss, _, g = loss_and_grads(state.params, cfg, micro(i))
            acc = [a + x / accum_steps for a, x in zip(acc, g)]
            losses.append(loss)
            del g
        lr_scale = linear_warmup_cosine(state.opt.step + 1, warmup_steps,
                                        total_steps)
        new_params, new_opt, om = adamw_update(
            state.params, acc, state.opt, opt_cfg, lr_scale,
            consume_grads=True)
        return TrainState(new_params, new_opt), {
            "loss": torch.mean(torch.stack(losses)), **om}

    return train_step


# --------------------------------------------------------------------------
# Serve steps
# --------------------------------------------------------------------------

def make_prefill_step(cfg: ModelConfig, max_len: int):
    def prefill_step(params, batch: dict):
        return D.prefill(params, cfg, batch, max_len)
    return prefill_step


def make_decode_step(cfg: ModelConfig):
    def decode_step(params, token, cache, enc_out=None):
        return D.decode_step(params, cfg, token, cache, enc_out=enc_out)
    return decode_step


# --------------------------------------------------------------------------
# meta-tensor input specs (the dry-run contract)
# --------------------------------------------------------------------------

def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def input_specs(cfg: ModelConfig, shape_name) -> dict:
    """Stand-ins for every input of (arch x shape): no allocation.
    ``shape_name`` names one of ``SHAPES`` or is an ``InputShape``.

    train:   {tokens, labels (+patches/frames)}
    prefill: {tokens (+patches/frames)}
    decode:  {token, cache, (enc_out)} — cache sized to seq_len.
    """
    sh = (shape_name if isinstance(shape_name, InputShape)
          else SHAPES[shape_name])
    b = sh.global_batch
    if sh.kind in ("train", "prefill"):
        spec = {"tokens": _meta((b, sh.seq_len), torch.int32)}
        if sh.kind == "train":
            spec["labels"] = _meta((b, sh.seq_len), torch.int32)
        if cfg.family == "vlm":
            spec["patches"] = _meta((b, cfg.num_patches, cfg.d_model),
                                    torch.bfloat16)
        if cfg.is_encoder_decoder:
            spec["frames"] = _meta((b, cfg.encoder_seq, cfg.d_model),
                                   torch.bfloat16)
        return spec

    # decode: token + cache filled to seq_len. On meta — a 32k x 128
    # full-config cache is terabytes; only its structure is made.
    spec = {"token": _meta((b, 1), torch.int32),
            "cache": D.init_cache(cfg, b, sh.seq_len + 8, device=META)}
    if cfg.is_encoder_decoder:
        spec["enc_out"] = _meta((b, cfg.encoder_seq, cfg.d_model),
                                torch.bfloat16)
    return spec


def params_specs(cfg: ModelConfig, with_opt: bool,
                 opt_cfg: Optional[AdamWConfig] = None):
    """``meta`` tensors for params (+ optimizer state): no memory spent on
    a 314B-param init."""
    params, _ = T.init_params(cfg, device=META)
    if not with_opt:
        return params
    return TrainState(params, adamw_init(params, opt_cfg))


def params_axes(cfg: ModelConfig):
    """Logical-axes tree (the init runs on ``meta``: axes are metadata)."""
    _, axes = T.init_params(cfg, device=META)
    return axes
