"""RWKV-6 "Finch" (arXiv:2404.05892): attention-free token mixing with
data-dependent per-channel decay.

Counterpart of ``repro/models/rwkv6.py``. Time-mix (per head, head_size
hs; state S is an [hs_k, hs_v] matrix):

    y_t = r_t @ (S_{t-1} + (u * k_t) v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T

with r/k/v/g and the decay w all produced through the "ddlerp" token-shift
low-rank interpolation of (x_t, x_{t-1}). Training runs
:func:`wkv_recurrence`, a sequential loop over time with JAX's step (its
``lax.scan`` body) in f32: a handful of launches a token on the card.
Decode is one step. State per stream is O(H * hs^2 + 2d), independent of
context length.

Channel-mix is RWKV's squared-ReLU FFN with token-shift and a receptance
gate; it plugs into the transformer as mlp kind "rwkv_cmix". Dtypes are
JAX's: the streams are f32, and each is cast to the parameter dtype before
its projection; the low-rank adapters multiply f32 activations by their
(possibly bf16) weights in f32, as JAX promotes them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.common.nodes import resolve_device
from repro_torch.models.layers import ParamRng, dense_init, mm, promoted

LORA_DIM = 32
DECAY_LORA_DIM = 64
_STREAMS = ("w", "k", "v", "r", "g")


class RWKV6State(NamedTuple):
    s: torch.Tensor         # [B, H, hs, hs] wkv state (f32)
    tm_shift: torch.Tensor  # [B, D] last token seen by time-mix
    cm_shift: torch.Tensor  # [B, D] last token seen by channel-mix


def rwkv6_init(rng: ParamRng, d_model: int, head_size: int,
               dtype=torch.bfloat16):
    if d_model % head_size:
        raise ValueError(f"d_model {d_model} is not a multiple of the head "
                         f"size {head_size}")
    h = d_model // head_size
    f32 = torch.float32
    p, a = {}, {}
    for z in ("r", "k", "v", "g"):
        p[f"w_{z}"], a[f"w_{z}"] = dense_init(
            rng, d_model, d_model, ("embed", "qkv_dim"), dtype)
    p["w_o"], a["w_o"] = dense_init(rng, d_model, d_model,
                                    ("qkv_dim", "embed"), dtype)
    # token-shift base mixes: maa_x plus one per stream (w,k,v,r,g)
    for z in ("x",) + _STREAMS:
        p[f"maa_{z}"] = rng.zeros((d_model,), f32)
        a[f"maa_{z}"] = ("embed",)
    # ddlerp low-rank adapters: [D, 5*LORA] and [5, LORA, D]
    p["tm_w1"] = rng.normal((d_model, 5 * LORA_DIM), 1e-2, dtype)
    a["tm_w1"] = ("embed", None)
    p["tm_w2"] = rng.normal((5, LORA_DIM, d_model), 1e-2, dtype)
    a["tm_w2"] = (None, None, "embed")
    # data-dependent decay lora + base
    p["td_w1"] = rng.normal((d_model, DECAY_LORA_DIM), 1e-2, dtype)
    a["td_w1"] = ("embed", None)
    p["td_w2"] = rng.normal((DECAY_LORA_DIM, d_model), 1e-2, dtype)
    a["td_w2"] = (None, "embed")
    p["decay_base"] = -rng.ones((d_model,), f32)
    a["decay_base"] = ("embed",)
    p["bonus_u"] = rng.normal((h, head_size), 1e-2, f32)
    a["bonus_u"] = ("heads", None)
    # per-head group norm on the wkv output
    p["ln_x_scale"] = rng.ones((d_model,), f32)
    a["ln_x_scale"] = ("embed",)
    p["ln_x_bias"] = rng.zeros((d_model,), f32)
    a["ln_x_bias"] = ("embed",)
    return p, a


def _shifted(xf: torch.Tensor) -> torch.Tensor:
    """x_{t-1} (zeros at t = 0): ``pad(x, 1 before)[:, :-1]``."""
    return F.pad(xf, (0, 0, 1, 0))[:, :-1]


def _ddlerp(p, x: torch.Tensor, sx: torch.Tensor):
    """Token-shift interpolation -> the five mixed streams (w,k,v,r,g).

    x: [B, S, D]; sx = x_{t-1} - x_t. Returns dict z -> [B, S, D].
    """
    xxx = x + sx * p["maa_x"]
    lora = torch.tanh(mm(xxx, p["tm_w1"]))                 # [B,S,5*L]
    b, s, _ = lora.shape
    lora = lora.reshape(b, s, 5, LORA_DIM)
    mixes = torch.einsum("bszl,zld->bszd",
                         *promoted(lora, p["tm_w2"]))        # [B,S,5,D]
    return {z: x + sx * (p[f"maa_{z}"] + mixes[:, :, i].to(torch.float32))
            for i, z in enumerate(_STREAMS)}


def _project(p, streams, h: int, hs: int):
    b, s, _ = streams["r"].shape
    dt = p["w_r"]["w"].dtype
    r = (streams["r"].to(dt) @ p["w_r"]["w"]).reshape(b, s, h, hs)
    k = (streams["k"].to(dt) @ p["w_k"]["w"]).reshape(b, s, h, hs)
    v = (streams["v"].to(dt) @ p["w_v"]["w"]).reshape(b, s, h, hs)
    g = F.silu(streams["g"].to(dt) @ p["w_g"]["w"])
    ww = p["decay_base"] + mm(
        torch.tanh(streams["w"].to(dt) @ p["td_w1"]),
        p["td_w2"]).to(torch.float32)
    w = torch.exp(-torch.exp(ww)).reshape(b, s, h, hs)     # decay in (0,1)
    return r, k, v, g, w


def _group_norm(p, y: torch.Tensor, h: int, hs: int, eps=1e-5):
    """Per-head LayerNorm over hs (RWKV's ln_x), with the population
    variance. y: [B, S, D]."""
    b, s, d = y.shape
    yh = y.reshape(b, s, h, hs).to(torch.float32)
    mu = yh.mean(-1, keepdim=True)
    var = yh.var(-1, keepdim=True, correction=0)
    yh = (yh - mu) * torch.rsqrt(var + eps)
    return yh.reshape(b, s, d) * p["ln_x_scale"] + p["ln_x_bias"]


def _wkv_step(state, r_t, k_t, v_t, w_t, u):
    """One token of every (batch, head) row n: ``kv = k v^T``, ``y = r
    (S + u * kv)``, ``S' = w * S + kv`` (JAX's ``lax.scan`` step, with
    the products as batched matrix products). state: [N, hs, hs]; r_t,
    v_t: [N, 1, hs]; k_t, w_t, u: [N, hs, 1]. Returns ``(y [N, 1, hs],
    new state)``."""
    kv = k_t * v_t
    y = torch.bmm(r_t, state + u * kv)
    return y, w_t * state + kv


def _rows(z, b: int, h: int, hs: int, col: bool):
    """[..., B, H, hs] f32 as [..., B*H, hs, 1] (``col``) or [..., B*H, 1,
    hs]."""
    z = z.to(torch.float32)
    shape = (b * h, hs, 1) if col else (b * h, 1, hs)
    return z.reshape(z.shape[:-3] + shape)


def wkv_recurrence(r, k, v, w, bonus_u):
    """The WKV recurrence over time from a zero state, token by token in
    f32. r, k, v, w: [B, S, H, hs]; bonus_u: [H, hs]. Returns ``(y [B, S,
    H, hs], final state [B, H, hs, hs])``. The operands are laid out for
    the step once, before the loop, so that a token costs its six
    launches and little host time."""
    b, s, h, hs = r.shape
    rs, vs = (_rows(z.transpose(0, 1), b, h, hs, False) for z in (r, v))
    ks, ws = (_rows(z.transpose(0, 1), b, h, hs, True) for z in (k, w))
    u = bonus_u.to(torch.float32).repeat(b, 1)[:, :, None]
    state = torch.zeros((b * h, hs, hs), dtype=torch.float32,
                        device=r.device)
    ys = []
    for t in range(s):
        y, state = _wkv_step(state, rs[t], ks[t], vs[t], ws[t], u)
        ys.append(y)
    y = torch.stack(ys).reshape(s, b, h, hs).transpose(0, 1)
    return y, state.reshape(b, h, hs, hs)


def rwkv6_time_mix(p, x: torch.Tensor, head_size: int,
                   return_state: bool = False):
    """Training/prefill forward. x: [B, S, D] -> [B, S, D].

    ``return_state=True`` also returns (final_S, final_tm_shift) for fused
    prefill."""
    b, s, d = x.shape
    h = d // head_size
    xf = x.to(torch.float32)
    streams = _ddlerp(p, xf, _shifted(xf) - xf)
    r, k, v, g, w = _project(p, streams, h, head_size)
    y, s_final = wkv_recurrence(r, k, v, w, p["bonus_u"])
    y = _group_norm(p, y.reshape(b, s, d), h, head_size)
    out = mm((y * g.to(torch.float32)).to(x.dtype), p["w_o"]["w"])
    if not return_state:
        return out
    return out, (s_final, xf[:, -1])


def rwkv6_time_mix_step(p, x: torch.Tensor, s_state: torch.Tensor,
                        shift: torch.Tensor, head_size: int):
    """Decode step. x: [B, 1, D]; returns (y [B,1,D], new_s, new_shift)."""
    b, _, d = x.shape
    h = d // head_size
    xf = x.to(torch.float32)
    streams = _ddlerp(p, xf, shift[:, None] - xf)
    r, k, v, g, w = _project(p, streams, h, head_size)
    hs = head_size
    y, new_s = _wkv_step(
        s_state.to(torch.float32).reshape(b * h, hs, hs),
        _rows(r[:, 0], b, h, hs, False), _rows(k[:, 0], b, h, hs, True),
        _rows(v[:, 0], b, h, hs, False), _rows(w[:, 0], b, h, hs, True),
        p["bonus_u"].to(torch.float32).repeat(b, 1)[:, :, None])
    y = _group_norm(p, y.reshape(b, 1, d), h, head_size)
    out = mm((y * g.to(torch.float32)).to(x.dtype), p["w_o"]["w"])
    return out, new_s.reshape(b, h, hs, hs), xf[:, 0]


# --------------------------------------------------------------------------
# Channel mix
# --------------------------------------------------------------------------

def rwkv6_cmix_init(rng: ParamRng, d_model: int, d_ff: int,
                    dtype=torch.bfloat16):
    p, a = {}, {}
    p["w_k"], a["w_k"] = dense_init(rng, d_model, d_ff,
                                    ("embed", "ffn"), dtype)
    p["w_v"], a["w_v"] = dense_init(rng, d_ff, d_model,
                                    ("ffn", "embed"), dtype)
    p["w_r"], a["w_r"] = dense_init(rng, d_model, d_model,
                                    ("embed", "qkv_dim"), dtype)
    p["maa_k"] = rng.zeros((d_model,), torch.float32)
    a["maa_k"] = ("embed",)
    p["maa_r"] = rng.zeros((d_model,), torch.float32)
    a["maa_r"] = ("embed",)
    return p, a


def rwkv6_cmix(p, x: torch.Tensor, shift=None):
    """x: [B, S, D]. shift: [B, D] previous token (decode) or None (train).

    Returns (out, last_token) so decode can carry the shift state.
    """
    xf = x.to(torch.float32)
    prev = _shifted(xf) if shift is None else shift[:, None]
    sx = prev - xf
    xk = (xf + sx * p["maa_k"]).to(x.dtype)
    xr = (xf + sx * p["maa_r"]).to(x.dtype)
    kk = torch.square(torch.relu(mm(xk, p["w_k"]["w"])))
    out = torch.sigmoid(mm(xr, p["w_r"]["w"]).to(torch.float32)) \
        * mm(kk, p["w_v"]["w"]).to(torch.float32)
    return out.to(x.dtype), xf[:, -1]


def rwkv6_empty_state(batch: int, d_model: int, head_size: int, *,
                      device=None) -> RWKV6State:
    """A zero state on ``device`` (the card unless the caller asks for the
    CPU)."""
    device = resolve_device(device)
    h = d_model // head_size
    f32 = torch.float32
    return RWKV6State(
        s=torch.zeros((batch, h, head_size, head_size), dtype=f32,
                      device=device),
        tm_shift=torch.zeros((batch, d_model), dtype=f32, device=device),
        cm_shift=torch.zeros((batch, d_model), dtype=f32, device=device))
