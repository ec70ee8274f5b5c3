"""The unified LM: the forward of the ten architectures.

Counterpart of the forward half of ``repro/models/transformer.py``:
``init_params`` + ``forward`` (teacher-forcing logits) + ``lm_loss``. The
parameters are a tree of tensors with JAX's layout and leaf names (dicts,
with lists for ``layers``), the form ``optim/``, ``common/tree.py`` and
``checkpoint/store.py`` take; :class:`LanguageModel` registers the same
leaves as an ``nn.Module``.

Layer layout: when the (mixer, mlp) pattern period divides num_layers, the
repeats are stacked along a leading "layers" dim (``layers/<slot>/...``
with a leading ``[n_rep]``) and run slot by slot for each repeat, as JAX's
``lax.scan`` does; otherwise ``layers`` is a per-layer list. JAX's
``jax.checkpoint`` (rematerialisation) is ``_remat``: while autograd
records (a train step), each decoder block and each encoder layer keeps
only its inputs and is recomputed in the backward
(``torch.utils.checkpoint``), which changes no value; a forward without
gradients runs the blocks plainly.

The mixers are attention (global, local, bidirectional), RG-LRU
(``rglru.py``) and RWKV-6 time-mix (``rwkv6.py``); the MLPs the gated and
plain ones, the MoE and RWKV-6's channel-mix. ``forward_with_cache`` is the
fused prefill: one forward that also builds the decode cache of
``decoding.py`` (``block_apply(..., collect_len=)``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.utils.checkpoint

from repro_torch.common import tree as tr
from repro_torch.common.nodes import resolve_device
from repro_torch.models import attention as attn_lib
from repro_torch.models import layers as L
from repro_torch.models import mlp as mlp_lib
from repro_torch.models import rglru as rglru_lib
from repro_torch.models import rwkv6 as rwkv_lib
from repro_torch.models.config import ModelConfig
from repro_torch.models.sharding import constrain

ATTN_MIXERS = ("attn", "local_attn", "bidir_attn")


def _dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def _norm_init(rng: L.ParamRng, cfg: ModelConfig, d: int):
    if cfg.norm_kind == "ln":
        return L.layernorm_init(rng, d, _dtype(cfg.param_dtype))
    return L.rmsnorm_init(rng, d, _dtype(cfg.param_dtype))


def _norm(cfg: ModelConfig, p, x):
    if cfg.norm_kind == "ln":
        return L.layernorm(p, x, cfg.norm_eps)
    return L.rmsnorm(p, x, cfg.norm_eps)


# ==========================================================================
# Block init
# ==========================================================================

def _attn_init(rng: L.ParamRng, cfg: ModelConfig):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    dt = _dtype(cfg.param_dtype)
    p, a = {}, {}
    p["wq"], a["wq"] = L.dense_init(rng, d, hq * hd, ("embed", "qkv_dim"),
                                    dt, bias=cfg.qkv_bias)
    p["wk"], a["wk"] = L.dense_init(rng, d, hkv * hd, ("embed", "kv_dim"),
                                    dt, bias=cfg.qkv_bias)
    p["wv"], a["wv"] = L.dense_init(rng, d, hkv * hd, ("embed", "kv_dim"),
                                    dt, bias=cfg.qkv_bias)
    p["wo"], a["wo"] = L.dense_init(rng, hq * hd, d, ("qkv_dim", "embed"),
                                    dt)
    return p, a


def block_init(rng: L.ParamRng, cfg: ModelConfig, layer: int,
               decoder: bool = True):
    """One residual block: mixer + mlp (+ cross-attn for enc-dec decoder)."""
    mixer = cfg.mixer_of(layer)
    mlp_kind = cfg.mlp_of(layer)
    dt = _dtype(cfg.param_dtype)
    p, a = {}, {}
    p["norm1"], a["norm1"] = _norm_init(rng, cfg, cfg.d_model)
    p["norm2"], a["norm2"] = _norm_init(rng, cfg, cfg.d_model)
    if cfg.use_post_norm:
        p["post_norm1"], a["post_norm1"] = _norm_init(rng, cfg, cfg.d_model)
        p["post_norm2"], a["post_norm2"] = _norm_init(rng, cfg, cfg.d_model)
    if mixer in ATTN_MIXERS:
        p["mixer"], a["mixer"] = _attn_init(rng, cfg)
    elif mixer == "rglru":
        p["mixer"], a["mixer"] = rglru_lib.rglru_init(
            rng, cfg.d_model, cfg.lru_width or cfg.d_model,
            cfg.conv_width, dt)
    elif mixer == "rwkv6":
        p["mixer"], a["mixer"] = rwkv_lib.rwkv6_init(
            rng, cfg.d_model, cfg.rwkv_head_size, dt)
    else:
        raise ValueError(mixer)

    if mlp_kind == "moe":
        p["mlp"], a["mlp"] = mlp_lib.moe_init(
            rng, cfg.d_model, cfg.d_ff, cfg.num_experts, dt)
    elif mlp_kind == "rwkv_cmix":
        p["mlp"], a["mlp"] = rwkv_lib.rwkv6_cmix_init(
            rng, cfg.d_model, cfg.d_ff, dt)
    else:
        p["mlp"], a["mlp"] = mlp_lib.mlp_init(
            rng, cfg.d_model, cfg.d_ff, mlp_kind, dt)
    if decoder and cfg.is_encoder_decoder:
        p["cross"], a["cross"] = _attn_init(rng, cfg)
        p["norm_cross"], a["norm_cross"] = _norm_init(rng, cfg, cfg.d_model)
    return p, a


# ==========================================================================
# Block apply (train / prefill)
# ==========================================================================

def _attn_apply_train(p, cfg: ModelConfig, x, kind: str, q_offset: int = 0,
                      kv_override=None, positions=None):
    b, s, _ = x.shape
    hd, hq, hkv = cfg.resolved_head_dim, cfg.num_heads, cfg.num_kv_heads

    q = L.dense(p["wq"], x)
    q = constrain(q, ("batch", "seq", "qkv_dim"))
    if kv_override is None:
        kx = L.dense(p["wk"], x)
        vx = L.dense(p["wv"], x)
        sk = s
    else:
        kx, vx = kv_override       # encoder output projections (cross-attn)
        sk = kx.shape[1]
    q = q.reshape(b, s, hq, hd)
    k = kx.reshape(b, sk, hkv, hd)
    v = vx.reshape(b, sk, hkv, hd)

    if cfg.use_rope and kind != "cross":
        pos_q = (positions if positions is not None
                 else q_offset + torch.arange(s, device=x.device))
        q = L.apply_rope(q, pos_q, cfg.rope_theta)
        if kv_override is None:
            k = L.apply_rope(k, torch.arange(sk, device=x.device),
                             cfg.rope_theta)

    attn_kind = {"attn": "causal", "local_attn": "local",
                 "bidir_attn": "bidir", "cross": "bidir"}[kind]
    out = attn_lib.flash_attention(
        q, k, v, kind=attn_kind, window=cfg.local_window,
        attn_softcap=cfg.attn_softcap, q_offset=q_offset,
        q_chunk=cfg.attn_q_chunk, kv_chunk=cfg.attn_kv_chunk)
    out = out.reshape(b, s, hq * hd)
    out = constrain(out, ("batch", "seq", "qkv_dim"))
    y = L.dense(p["wo"], out)
    return y, (k, v)


def block_apply(p, cfg: ModelConfig, layer: int, x,
                enc_kv=None, decoder: bool = True,
                collect_len: Optional[int] = None):
    """Training forward for one block.

    ``collect_len``: if set, also build and return this layer's decode cache
    (fused prefill — K/V and recurrent states are captured in the same pass
    instead of replaying the layer). Returns x, or (x, cache_dict).
    """
    mixer = cfg.mixer_of(layer)
    mlp_kind = cfg.mlp_of(layer)
    s = x.shape[1]
    lc = {} if collect_len is not None else None

    h = _norm(cfg, p["norm1"], x)
    if mixer in ATTN_MIXERS:
        y, (k, v) = _attn_apply_train(p["mixer"], cfg, h, mixer)
        if lc is not None:
            lc.update(_collect_attn_cache(cfg, mixer, k, v, s, collect_len))
    elif mixer == "rglru":
        if lc is not None:
            y, lc["kind_rglru"] = rglru_lib.rglru_block(
                p["mixer"], h, return_state=True)
        else:
            y = rglru_lib.rglru_block(p["mixer"], h)
    elif mixer == "rwkv6":
        if lc is not None:
            y, (s_f, shift_f) = rwkv_lib.rwkv6_time_mix(
                p["mixer"], h, cfg.rwkv_head_size, return_state=True)
            lc["kind_rwkv"] = rwkv_lib.RWKV6State(
                s=s_f, tm_shift=shift_f, cm_shift=torch.zeros_like(shift_f))
        else:
            y = rwkv_lib.rwkv6_time_mix(p["mixer"], h, cfg.rwkv_head_size)
    else:
        raise ValueError(mixer)
    if cfg.use_post_norm:
        y = _norm(cfg, p["post_norm1"], y)
    x = x + y
    x = constrain(x, ("batch", "seq", "embed"))

    if decoder and cfg.is_encoder_decoder and enc_kv is not None:
        h = _norm(cfg, p["norm_cross"], x)
        y, _ = _attn_apply_train(p["cross"], cfg, h, "cross",
                                 kv_override=enc_kv)
        x = x + y

    h = _norm(cfg, p["norm2"], x)
    if mlp_kind == "moe":
        y = mlp_lib.moe_apply(
            p["mlp"], h, num_experts=cfg.num_experts,
            top_k=cfg.num_experts_per_tok,
            capacity_factor=cfg.moe_capacity_factor,
            group_size=cfg.moe_group_size)
    elif mlp_kind == "rwkv_cmix":
        y, _ = rwkv_lib.rwkv6_cmix(p["mlp"], h)
        if lc is not None:
            lc["cmix_shift"] = h.to(torch.float32)[:, -1]
    else:
        y = mlp_lib.mlp_apply(p["mlp"], h, mlp_kind)
    if cfg.use_post_norm:
        y = _norm(cfg, p["post_norm2"], y)
    x = x + y
    x = constrain(x, ("batch", "seq", "embed"))
    if lc is not None:
        return x, lc
    return x


def _collect_attn_cache(cfg: ModelConfig, mixer: str, k, v, s: int,
                        max_len: int):
    """Pack prefill K/V [B, S, Hkv, D] into the decode cache layout: the
    whole prompt into a fresh full cache, or its last ``min(window, S)``
    positions into a ring, position p at slot ``p % window``."""
    b, _, hkv, hd = k.shape
    dev = k.device
    if mixer in ("attn", "bidir_attn"):
        cache = attn_lib.empty_cache(b, max_len, hkv, hd, k.dtype,
                                     device=dev)
        cache.k[:, :s] = k
        cache.v[:, :s] = v
        cache.length.fill_(s)
        return {"kind_attn": cache}
    wnd = min(cfg.local_window, max_len)
    take = min(wnd, s)
    positions = torch.arange(s - take, s, device=dev)
    slots = positions % wnd
    cache = attn_lib.empty_ring_cache(b, wnd, hkv, hd, k.dtype, device=dev)
    cache.k[:, slots] = k[:, s - take:]
    cache.v[:, slots] = v[:, s - take:]
    cache.pos[slots] = positions.to(torch.int32)
    cache.length.fill_(s)
    return {"kind_local": cache}


# ==========================================================================
# Model init
# ==========================================================================

def _copy_into(out, tree, i: int) -> None:
    """Write every leaf of ``tree`` into slice ``i`` of ``out``'s leaf."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _copy_into(out[k], v, i)
        else:
            out[k][i].copy_(v)


def _stacked(fn, n: int):
    """Stack n init results along a new leading dim; returns (params, axes
    of ONE element — param_shardings prepends the 'layers' dim). Each
    result is written into its slice of the stack as soon as it is made,
    so no more than one layer's leaves exist besides the stack."""
    first, axes = fn()

    def alloc(tree):
        return {k: alloc(v) if isinstance(v, dict) else torch.empty(
            (n,) + tuple(v.shape), dtype=v.dtype, device=v.device)
            for k, v in tree.items()}

    out = alloc(first)
    _copy_into(out, first, 0)
    del first
    for i in range(1, n):
        _copy_into(out, fn()[0], i)
    return out, axes


def init_params(cfg: ModelConfig, *, generator: Optional[torch.Generator]
                = None, device=None):
    """``(params, axes)``: random parameters on ``device`` (the card unless
    the caller asks for the CPU; ``"meta"`` gives shapes and dtypes with no
    memory), drawn from ``generator`` (a fresh one seeded 0 on ``device``
    if none). Leaf names, shapes and dtypes are JAX's; the values are the
    port's own draws, from JAX's distributions."""
    device = resolve_device(device)
    if generator is None and device.type != "meta":
        generator = torch.Generator(device=device).manual_seed(0)
    rng = L.ParamRng(generator, device)
    dt = _dtype(cfg.param_dtype)
    p, a = {}, {}
    p["embed"], a["embed"] = L.embedding_init(rng, cfg.padded_vocab,
                                              cfg.d_model, dt)
    if not cfg.tie_embeddings:
        p["unembed"], a["unembed"] = L.embedding_init(
            rng, cfg.padded_vocab, cfg.d_model, dt)
    if cfg.use_abs_pos:
        p["pos"], a["pos"] = L.abs_pos_init(rng, cfg.max_abs_pos,
                                            cfg.d_model, dt)
    p["final_norm"], a["final_norm"] = _norm_init(rng, cfg, cfg.d_model)

    period = cfg.uniform_period
    if period < cfg.num_layers:
        n_rep = cfg.num_layers // period
        slots = [_stacked(lambda s=s: block_init(rng, cfg, s), n_rep)
                 for s in range(period)]
        p["layers"] = [sp for sp, _ in slots]
        a["layers"] = [sa for _, sa in slots]
    else:
        per = [block_init(rng, cfg, i) for i in range(cfg.num_layers)]
        p["layers"] = [t[0] for t in per]
        a["layers"] = [t[1] for t in per]

    if cfg.is_encoder_decoder:
        # encoder blocks are uniform bidir-attn: stacked
        p["encoder"], a["encoder"] = _stacked(
            lambda: block_init(rng, cfg, 0, decoder=False),
            cfg.encoder_layers)
        p["enc_norm"], a["enc_norm"] = _norm_init(rng, cfg, cfg.d_model)
        p["enc_pos"], a["enc_pos"] = L.abs_pos_init(
            rng, cfg.encoder_seq, cfg.d_model, dt)
    return p, a


# ==========================================================================
# Forward (train / prefill math)
# ==========================================================================

def _index(tree, i: int):
    """Slice ``i`` of every leaf of a stacked tree (views)."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _embed_inputs(p, cfg: ModelConfig, batch: dict):
    """tokens (+ optional patch/frame prefix) -> [B, S_total, D], and the
    number of prefix positions (excluded from the LM loss). Learned
    positions are added for decoder-only models alone, as in JAX: an
    encoder-decoder's decoder (whisper) gets no position here."""
    x = L.embed(p["embed"], batch["tokens"])
    if cfg.family == "vlm" and "patches" in batch:
        x = torch.cat([batch["patches"].to(x.dtype), x], dim=1)
        prefix = batch["patches"].shape[1]
    else:
        prefix = 0
    if cfg.use_abs_pos and not cfg.is_encoder_decoder:
        s = x.shape[1]
        x = x + p["pos"]["pos"][:s]
    if cfg.scale_embed:                                   # gemma family
        x = x * embed_scale(cfg, x)
    return x, prefix


def embed_scale(cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """sqrt(d_model) in ``x``'s dtype, as a 0-dim tensor on its device (a
    fill, not a copy from the host), as JAX rounds it before the
    product."""
    return torch.full((), cfg.d_model ** 0.5, dtype=x.dtype, device=x.device)


def _remat(fn, x: torch.Tensor, *args):
    """``fn(x, *args)``; while autograd records through ``x``, checkpointed
    (JAX's ``jax.checkpoint``): its activations are recomputed in the
    backward instead of kept."""
    if torch.is_grad_enabled() and x.requires_grad:
        return torch.utils.checkpoint.checkpoint(fn, x, *args,
                                                 use_reentrant=False)
    return fn(x, *args)


def _enc_layer(x, lp, cfg: ModelConfig):
    h = _norm(cfg, lp["norm1"], x)
    y, _ = _attn_apply_train(lp["mixer"], cfg, h, "bidir_attn")
    x = x + y
    h = _norm(cfg, lp["norm2"], x)
    return x + mlp_lib.mlp_apply(lp["mlp"], h, cfg.mlp_of(0))


def _encode(p, cfg: ModelConfig, frames: torch.Tensor):
    """Whisper encoder over precomputed conv-frontend frames [B, T, D]."""
    x = frames.to(_dtype(cfg.compute_dtype))
    x = x + p["enc_pos"]["pos"][:x.shape[1]]
    for i in range(cfg.encoder_layers):
        x = _remat(_enc_layer, x, _index(p["encoder"], i), cfg)
    return _norm(cfg, p["enc_norm"], x)


def _layer_params(p, cfg: ModelConfig):
    """``(layer, params)`` for every decoder layer, in order: slot s of
    repeat r is layer ``r * period + s`` of the stacked layout."""
    period = cfg.uniform_period
    if period < cfg.num_layers:
        n_rep = cfg.num_layers // period
        for r in range(n_rep):
            for s in range(period):
                yield s, _index(p["layers"][s], r)
    else:
        yield from enumerate(p["layers"])


def forward(p, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    """Teacher-forcing logits [B, S_tokens, padded_vocab] (f32), on the
    device the parameters live on."""
    x, prefix = _embed_inputs(p, cfg, batch)
    x = constrain(x, ("batch", "seq", "embed"))

    enc_out = None
    if cfg.is_encoder_decoder:
        enc_out = _encode(p, cfg, batch["frames"])

    for layer, lp in _layer_params(p, cfg):
        ekv = None
        if enc_out is not None:
            ekv = (L.dense(lp["cross"]["wk"], enc_out),
                   L.dense(lp["cross"]["wv"], enc_out))
        x = _remat(lambda x, lp, ekv, layer=layer: block_apply(
            lp, cfg, layer, x, enc_kv=ekv), x, lp, ekv)

    x = _norm(cfg, p["final_norm"], x)
    if prefix:
        x = x[:, prefix:]
    head = p["embed"] if cfg.tie_embeddings else p["unembed"]
    logits = L.unembed(head, x, cfg.logit_softcap)
    return constrain(logits, ("batch", "seq", "vocab"))


def forward_with_cache(p, cfg: ModelConfig, batch: dict, max_len: int):
    """Fused prefill: one forward pass that also builds the decode cache.

    Returns (logits [B, S_tokens, Vp], cache, enc_out or None). Cache layout
    matches ``repro_torch.models.decoding.init_cache``: for a stacked
    pattern, slot s's caches of the repeats stacked into ``[R, ...]``
    leaves; otherwise one cache a layer.
    """
    x, prefix = _embed_inputs(p, cfg, batch)
    x = constrain(x, ("batch", "seq", "embed"))

    enc_out = None
    if cfg.is_encoder_decoder:
        enc_out = _encode(p, cfg, batch["frames"])

    caches = []
    for layer, lp in _layer_params(p, cfg):
        ekv = None
        if enc_out is not None:
            ekv = (L.dense(lp["cross"]["wk"], enc_out),
                   L.dense(lp["cross"]["wv"], enc_out))
        x, lc = block_apply(lp, cfg, layer, x, enc_kv=ekv,
                            collect_len=max_len)
        caches.append(lc)
    period = cfg.uniform_period
    if period < cfg.num_layers:
        caches = [tr.tree_map(lambda *xs: torch.stack(xs), *caches[s::period])
                  for s in range(period)]

    x = _norm(cfg, p["final_norm"], x)
    if prefix:
        x = x[:, prefix:]
    head = p["embed"] if cfg.tie_embeddings else p["unembed"]
    logits = L.unembed(head, x, cfg.logit_softcap)
    return constrain(logits, ("batch", "seq", "vocab")), caches, enc_out


def lm_loss(p, cfg: ModelConfig, batch: dict):
    """Next-token cross-entropy with padded-vocab masking: ``(loss,
    metrics)``, metrics ``loss``, ``tokens`` and ``logit_max``."""
    logits = forward(p, cfg, batch)            # [B, S, Vp] f32
    labels = batch["labels"]
    vp = cfg.padded_vocab
    mask = torch.arange(vp, device=logits.device) < cfg.vocab_size
    logits = torch.where(mask, logits, -1e30)
    logz = torch.logsumexp(logits, dim=-1)
    # an invalid (negative) label's gold logit is masked out below
    gold = torch.gather(logits, -1, labels.clamp(min=0).to(torch.int64)
                        [..., None])[..., 0]
    nll = logz - gold
    valid = (labels >= 0).to(torch.float32)
    loss = torch.sum(nll * valid) / torch.clamp(torch.sum(valid), min=1.0)
    metrics = {"loss": loss,
               "tokens": torch.sum(valid),
               "logit_max": torch.max(logits)}
    return loss, metrics


# ==========================================================================
# nn.Module view
# ==========================================================================

def _module_tree(tree) -> nn.Module:
    """Dicts as ``nn.ModuleDict``, lists as ``nn.ModuleList``, tensors as
    parameters of their parent, so ``state_dict`` names are the JAX paths
    with ``/`` written as ``.``."""
    if isinstance(tree, list):
        return nn.ModuleList(_module_tree(t) for t in tree)
    mod = nn.ModuleDict()
    for k, v in tree.items():
        if isinstance(v, torch.Tensor):
            mod.register_parameter(k, nn.Parameter(v, requires_grad=False))
        else:
            mod[k] = _module_tree(v)
    return mod


def _param_tree(mod: nn.Module):
    if isinstance(mod, nn.ModuleList):
        return [_param_tree(m) for m in mod]
    tree = dict(mod.named_parameters(recurse=False))
    tree.update({k: _param_tree(m) for k, m in mod.named_children()})
    return tree


class LanguageModel(nn.Module):
    """The parameter tree as an ``nn.Module``: the same tensors, registered
    as parameters that need no gradient, so that ``state_dict`` names are
    the JAX paths with ``/`` written as ``.``. ``forward(batch)`` is
    :func:`forward`. ``params`` defaults to :func:`init_params`'s, on
    ``device`` from ``generator``."""

    def __init__(self, cfg: ModelConfig, params=None, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.cfg = cfg
        if params is None:
            params, _ = init_params(cfg, generator=generator, device=device)
        tree = _module_tree(params)
        for k, v in tree.named_children():
            self.add_module(k, v)
        for k, v in tree.named_parameters(recurse=False):
            self.register_parameter(k, v)

    def params(self):
        """The parameter tree (JAX's layout) of this module's tensors."""
        return _param_tree(self)

    def forward(self, batch: dict) -> torch.Tensor:
        return forward(self.params(), self.cfg, batch)
