"""Serving path: prefill + single-token decode for every architecture.

Counterpart of ``repro/models/decoding.py``. Cache layout mirrors the
parameter layout (stacked [R, ...] leaves for stacked layer groups;
per-layer lists otherwise). Per-mixer cache kinds:

    attn        -> KVCache (full [B, S_max, Hkv, D] + length)
    local_attn  -> RingKVCache (window slots — bounded state)
    rglru       -> RGLRUState (h + conv tail)
    rwkv6       -> RWKV6State (wkv matrix state + token shifts)

``decode_step`` ordering convention: the cache is updated with the current
token's K/V (or recurrent state) *first*, then attention/readout runs
against the updated cache — so a fresh decode at position L attends to
positions [0, L] inclusive.

``decode_step`` writes the token into the cache it is given (each layer's
K/V slot, its length, its recurrent state, through views into a stacked
leaf) and returns that cache: it consumes its input, as a donated buffer
is consumed under ``jax.jit``. A functional write would copy every layer's
whole cache at every token. Positions are read from the cache's 0-dim
``length`` on the device, never on the host.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch.common import tree as tr
from repro_torch.common.nodes import resolve_device
from repro_torch.models import attention as attn_lib
from repro_torch.models import layers as L
from repro_torch.models import mlp as mlp_lib
from repro_torch.models import rglru as rglru_lib
from repro_torch.models import rwkv6 as rwkv_lib
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.sharding import constrain
from repro_torch.models.transformer import (
    _attn_apply_train,
    _dtype,
    _embed_inputs,
    _encode,
    _index,
    _norm,
    embed_scale,
)


class LayerCache(NamedTuple):
    """Per-layer decode state. Exactly one field is populated per mixer
    kind; unused fields hold size-zero placeholders so the tree structure
    stays uniform inside stacked layer groups of the same kind."""
    kind: str
    attn: Any = None        # KVCache | RingKVCache
    rglru: Any = None       # RGLRUState
    rwkv: Any = None        # RWKV6State fields (s, tm_shift)
    cmix_shift: Any = None  # [B, D] rwkv channel-mix shift
    cross_kv: Any = None    # (k, v) static encoder projections


def _empty_layer_cache(cfg: ModelConfig, mixer: str, batch: int,
                       max_len: int, dtype, device) -> dict:
    hd, hkv = cfg.resolved_head_dim, cfg.num_kv_heads
    if mixer == "attn":
        return {"kind_attn": attn_lib.empty_cache(batch, max_len, hkv, hd,
                                                  dtype, device=device)}
    if mixer == "local_attn":
        wnd = min(cfg.local_window, max_len)
        return {"kind_local": attn_lib.empty_ring_cache(
            batch, wnd, hkv, hd, dtype, device=device)}
    if mixer == "rglru":
        return {"kind_rglru": rglru_lib.rglru_empty_state(
            batch, cfg.lru_width or cfg.d_model, cfg.conv_width, dtype,
            device=device)}
    if mixer == "rwkv6":
        return {"kind_rwkv": rwkv_lib.rwkv6_empty_state(
            batch, cfg.d_model, cfg.rwkv_head_size, device=device)}
    raise ValueError(mixer)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device=None):
    """Cache tree matching the layer layout of init_params, on ``device``
    (the card unless the caller asks for the CPU; ``"meta"`` gives the
    structure with no memory)."""
    device = resolve_device(device)
    dtype = _dtype(cfg.param_dtype)
    period = cfg.uniform_period

    def one(layer):
        c = _empty_layer_cache(cfg, cfg.mixer_of(layer), batch, max_len,
                               dtype, device)
        if cfg.mlp_of(layer) == "rwkv_cmix":
            c["cmix_shift"] = torch.zeros((batch, cfg.d_model),
                                          dtype=torch.float32, device=device)
        return c

    if period < cfg.num_layers:
        n_rep = cfg.num_layers // period
        return [tr.tree_map(lambda x: x.unsqueeze(0).repeat(
            (n_rep,) + (1,) * x.dim()), one(s)) for s in range(period)]
    return [one(i) for i in range(cfg.num_layers)]


# --------------------------------------------------------------------------
# Per-block decode step
# --------------------------------------------------------------------------

def _attn_decode(p, cfg: ModelConfig, x, cache, mixer: str):
    b = x.shape[0]
    hd, hq, hkv = cfg.resolved_head_dim, cfg.num_heads, cfg.num_kv_heads
    q = L.dense(p["wq"], x).reshape(b, 1, hq, hd)
    k = L.dense(p["wk"], x).reshape(b, 1, hkv, hd)
    v = L.dense(p["wv"], x).reshape(b, 1, hkv, hd)
    pos = cache.length  # current token's absolute position
    if cfg.use_rope:
        q = L.apply_rope(q, pos[None], cfg.rope_theta)
        k = L.apply_rope(k, pos[None], cfg.rope_theta)
    if mixer == "attn":
        cache = attn_lib.update_cache_(cache, k, v)
        out = attn_lib.decode_attention(q, cache, cfg.attn_softcap)
    else:
        cache = attn_lib.update_ring_cache_(cache, k, v)
        out = attn_lib.decode_attention_ring(q, cache, cfg.local_window,
                                             cfg.attn_softcap)
    return L.dense(p["wo"], out.reshape(b, 1, hq * hd))


def _cross_decode(p, cfg: ModelConfig, x, cross_kv):
    b = x.shape[0]
    hd, hq, hkv = cfg.resolved_head_dim, cfg.num_heads, cfg.num_kv_heads
    k, v = cross_kv
    sk = k.shape[1]
    q = L.dense(p["wq"], x).reshape(b, 1, hq, hd)
    cache = attn_lib.KVCache(
        k=k.reshape(b, sk, hkv, hd), v=v.reshape(b, sk, hkv, hd),
        length=torch.full((), sk, dtype=torch.int32, device=x.device))
    out = attn_lib.decode_attention(q, cache, cfg.attn_softcap)
    return L.dense(p["wo"], out.reshape(b, 1, hq * hd))


def block_decode(p, cfg: ModelConfig, layer: int, x, cache: dict,
                 cross_kv=None):
    """One block on one token [B, 1, D]. ``cache`` (this layer's, its
    tensors possibly views into stacked leaves) is updated in place;
    returns ``(x, cache)``."""
    mixer = cfg.mixer_of(layer)
    mlp_kind = cfg.mlp_of(layer)

    h = _norm(cfg, p["norm1"], x)
    if mixer in ("attn", "local_attn"):
        key = "kind_attn" if mixer == "attn" else "kind_local"
        y = _attn_decode(p["mixer"], cfg, h, cache[key], mixer)
    elif mixer == "rglru":
        st = cache["kind_rglru"]
        y, new = rglru_lib.rglru_decode_step(p["mixer"], h, st)
        st.h.copy_(new.h)
        st.conv.copy_(new.conv)
    elif mixer == "rwkv6":
        st = cache["kind_rwkv"]
        y, new_s, new_shift = rwkv_lib.rwkv6_time_mix_step(
            p["mixer"], h, st.s, st.tm_shift, cfg.rwkv_head_size)
        st.s.copy_(new_s)
        st.tm_shift.copy_(new_shift)
    else:
        raise ValueError(mixer)
    if cfg.use_post_norm:
        y = _norm(cfg, p["post_norm1"], y)
    x = x + y

    if cross_kv is not None:
        h = _norm(cfg, p["norm_cross"], x)
        x = x + _cross_decode(p["cross"], cfg, h, cross_kv)

    h = _norm(cfg, p["norm2"], x)
    if mlp_kind == "moe":
        y = mlp_lib.moe_apply(
            p["mlp"], h, num_experts=cfg.num_experts,
            top_k=cfg.num_experts_per_tok,
            capacity_factor=cfg.moe_capacity_factor,
            group_size=min(cfg.moe_group_size, h.shape[0] * h.shape[1]))
    elif mlp_kind == "rwkv_cmix":
        y, new_shift = rwkv_lib.rwkv6_cmix(p["mlp"], h, cache["cmix_shift"])
        cache["cmix_shift"].copy_(new_shift)
    else:
        y = mlp_lib.mlp_apply(p["mlp"], h, mlp_kind)
    if cfg.use_post_norm:
        y = _norm(cfg, p["post_norm2"], y)
    return x + y, cache


# --------------------------------------------------------------------------
# decode_step / prefill entry points
# --------------------------------------------------------------------------

def _cross_kv(lp, enc_out):
    if enc_out is None:
        return None
    return (L.dense(lp["cross"]["wk"], enc_out),
            L.dense(lp["cross"]["wv"], enc_out))


def decode_step(params, cfg: ModelConfig, token: torch.Tensor, cache,
                enc_out: Optional[torch.Tensor] = None):
    """token: [B, 1] int32. Returns (logits [B, 1, Vp] f32, cache): the
    cache given, updated in place (see the module docstring).

    For enc-dec models pass ``enc_out`` (encoder activations [B, T, D]);
    cross K/V are recomputed per layer from it at every step, as JAX's
    decode does.
    """
    x = L.embed(params["embed"], token)
    if cfg.scale_embed:
        x = x * embed_scale(cfg, x)
    if cfg.use_abs_pos and not cfg.is_encoder_decoder:
        # JAX's dynamic_slice clamps the start into the table
        pos = _cache_length(cfg, cache).clamp(0, cfg.max_abs_pos - 1)
        x = x + torch.index_select(params["pos"]["pos"], 0,
                                   pos.reshape(1).to(torch.int64))
    x = constrain(x, ("batch", "seq", "embed"))

    period = cfg.uniform_period
    if period < cfg.num_layers:
        # layer i = slot i % period of repeat i // period, as in forward
        for r in range(cfg.num_layers // period):
            for s in range(period):
                lp = _index(params["layers"][s], r)
                lc = tr.tree_map(lambda a, r=r: a[r], cache[s])
                x, _ = block_decode(lp, cfg, s, x, lc,
                                    cross_kv=_cross_kv(lp, enc_out))
    else:
        for i, (lp, lc) in enumerate(zip(params["layers"], cache)):
            x, _ = block_decode(lp, cfg, i, x, lc,
                                cross_kv=_cross_kv(lp, enc_out))

    x = _norm(cfg, params["final_norm"], x)
    head = params["embed"] if cfg.tie_embeddings else params["unembed"]
    logits = L.unembed(head, x, cfg.logit_softcap)
    return constrain(logits, ("batch", "seq", "vocab")), cache


def _cache_length(cfg: ModelConfig, cache) -> torch.Tensor:
    """0-dim int32 count of tokens already in the cache (before this
    step), on the cache's device."""
    leaf = cache[0]
    for key in ("kind_attn", "kind_local"):
        if key in leaf:
            ln = leaf[key].length
            return (ln[0] if ln.dim() else ln).to(torch.int32)
    # recurrent-only models don't track position (no rope/abs pos needed)
    return torch.zeros((), dtype=torch.int32,
                       device=tr.tree_leaves(leaf)[0].device)


def prefill(params, cfg: ModelConfig, batch: dict, max_len: int):
    """Run the prompt, build the cache — FUSED single pass (K/V and
    recurrent states captured during the forward; see
    ``transformer.forward_with_cache``).

    Returns (last_logits [B, 1, Vp], cache, enc_out or None).
    """
    _check_room(cfg, batch, max_len)
    logits, cache, enc_out = T.forward_with_cache(params, cfg, batch,
                                                  max_len)
    return logits[:, -1:], cache, enc_out


def prefill_reference(params, cfg: ModelConfig, batch: dict, max_len: int):
    """Replay-based prefill oracle (forward for logits + per-layer replay
    for states). Quadratic in passes but independently derived — tests
    assert the fused path matches this."""
    _check_room(cfg, batch, max_len)
    logits = T.forward(params, cfg, batch)
    cache = init_cache(cfg, batch["tokens"].shape[0], max_len,
                       device=batch["tokens"].device)
    cache = _fill_cache(params, cfg, batch, cache)
    enc_out = None
    if cfg.is_encoder_decoder:
        enc_out = _encode(params, cfg, batch["frames"])
    return logits[:, -1:], cache, enc_out


def _check_room(cfg: ModelConfig, batch: dict, max_len: int):
    prompt_len = batch["tokens"].shape[1]
    if cfg.family == "vlm" and "patches" in batch:
        prompt_len += batch["patches"].shape[1]
    if not max_len > prompt_len:
        raise ValueError(
            f"cache max_len={max_len} leaves no room to decode beyond the "
            f"prompt ({prompt_len} positions incl. any patch/frame prefix)")


def _fill_cache(params, cfg: ModelConfig, batch: dict, cache):
    """Recompute per-layer inputs and write prefill K/V + recurrent states.

    This recomputes the forward pass once more (the fused path is
    ``forward_with_cache``); the semantics (and tests) live here. Works for
    both stacked and per-layer layouts by flattening to per-layer
    processing.
    """
    x, _ = _embed_inputs(params, cfg, batch)
    s = x.shape[1]
    period = cfg.uniform_period
    stacked = period < cfg.num_layers

    def layer_params(i):
        if stacked:
            return _index(params["layers"][i % period], i // period)
        return params["layers"][i]

    def set_layer_cache(i, lc):
        if stacked:
            for full, new in zip(tr.tree_leaves(cache[i % period]),
                                 tr.tree_leaves(lc)):
                full[i // period].copy_(new)
        else:
            cache[i] = lc

    enc_out = _encode(params, cfg, batch["frames"]) \
        if cfg.is_encoder_decoder else None

    for i in range(cfg.num_layers):
        lp = layer_params(i)
        if stacked:
            lc = dict(tr.tree_map(lambda a, i=i: a[i // period].clone(),
                                  cache[i % period]))
        else:
            lc = dict(cache[i])
        mixer = cfg.mixer_of(i)
        h = _norm(cfg, lp["norm1"], x)
        if mixer in ("attn", "local_attn"):
            key = "kind_attn" if mixer == "attn" else "kind_local"
            _, (k, v) = _attn_apply_train(lp["mixer"], cfg, h, mixer)
            if mixer == "attn":
                lc[key] = attn_lib.prefill_into_cache(lc[key], k, v, s)
            else:
                # ring invariant: position p lives at slot p % window
                wnd = lc[key].k.shape[1]
                take = min(wnd, s)
                positions = torch.arange(s - take, s, device=x.device)
                slots = positions % wnd
                pos = torch.full((wnd,), -1, dtype=torch.int32,
                                 device=x.device)
                pos[slots] = positions.to(torch.int32)
                kc, vc = lc[key].k.clone(), lc[key].v.clone()
                kc[:, slots] = k[:, s - take:]
                vc[:, slots] = v[:, s - take:]
                lc[key] = attn_lib.RingKVCache(
                    k=kc, v=vc, pos=pos,
                    length=torch.full((), s, dtype=torch.int32,
                                      device=x.device))
        elif mixer == "rglru":
            lc["kind_rglru"] = _rglru_prefill_state(lp["mixer"], h, cfg)
        elif mixer == "rwkv6":
            lc["kind_rwkv"] = _rwkv_prefill_state(lp["mixer"], h, cfg,
                                                  lc["kind_rwkv"])
        # advance x through the full block for the next layer's input
        x_next = T.block_apply(lp, cfg, i, x,
                               enc_kv=_cross_kv(lp, enc_out))
        if cfg.mlp_of(i) == "rwkv_cmix":
            # channel-mix shift = last token of its input stream
            x_mid = x + _mixer_out_only(lp, cfg, i, x)
            lc["cmix_shift"] = _norm(cfg, lp["norm2"], x_mid)[:, -1].to(
                torch.float32)
        x = x_next
        set_layer_cache(i, lc)
    return cache


def _mixer_out_only(lp, cfg, layer, x):
    mixer = cfg.mixer_of(layer)
    h = _norm(cfg, lp["norm1"], x)
    if mixer in ("attn", "local_attn", "bidir_attn"):
        y, _ = _attn_apply_train(lp["mixer"], cfg, h, mixer)
    elif mixer == "rglru":
        y = rglru_lib.rglru_block(lp["mixer"], h)
    else:
        y = rwkv_lib.rwkv6_time_mix(lp["mixer"], h, cfg.rwkv_head_size)
    if cfg.use_post_norm:
        y = _norm(cfg, lp["post_norm1"], y)
    return y


def _rglru_prefill_state(p, h, cfg: ModelConfig):
    """Final RG-LRU state after consuming h [B, S, D], token by token."""
    width = cfg.lru_width or cfg.d_model
    st = rglru_lib.rglru_empty_state(h.shape[0], width, cfg.conv_width,
                                     _dtype(cfg.param_dtype), device=h.device)
    for t in range(h.shape[1]):
        _, st = rglru_lib.rglru_decode_step(p, h[:, t:t + 1], st)
    return st


def _rwkv_prefill_state(p, h, cfg: ModelConfig, st):
    s, shift = st.s, st.tm_shift
    for t in range(h.shape[1]):
        _, s, shift = rwkv_lib.rwkv6_time_mix_step(
            p, h[:, t:t + 1], s, shift, cfg.rwkv_head_size)
    return st._replace(s=s, tm_shift=shift)
