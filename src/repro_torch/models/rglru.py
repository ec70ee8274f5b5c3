"""Griffin/RecurrentGemma recurrent block: causal conv1d + RG-LRU.

Counterpart of ``repro/models/rglru.py`` (arXiv:2402.19427). The block:

    x -> [linear -> gelu]───────────────┐
    x -> [linear -> conv1d(4) -> RG-LRU]─⊙──> linear -> out

RG-LRU recurrence (c = 8):

    r_t = sigmoid(W_a x_t + b_a)          # recurrence gate
    i_t = sigmoid(W_x x_t + b_x)          # input gate
    a_t = exp(-c * softplus(Lambda) * r_t)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Training runs :func:`associative_scan`, JAX's odd/even recursion of
``jax.lax.associative_scan`` transcribed (the same slices, ``combine``
order and interleave, so the same association and the same f32 bits):
O(log S) rounds of elementwise launches on the card. Decode is one step.
Where torch's defaults differ from JAX's, JAX's are kept: the tanh GELU,
softplus as ``logaddexp(x, 0)`` (torch's ``softplus`` switches to the
identity above 20), and the gates' products in the parameter dtype before
the f32 cast.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.common.nodes import resolve_device
from repro_torch.models.layers import (ParamRng, dense_init, gelu, mm,
                                       promoted)

RGLRU_C = 8.0


class RGLRUState(NamedTuple):
    h: torch.Tensor          # [B, W] recurrent state (f32)
    conv: torch.Tensor       # [B, conv_width - 1, W] trailing inputs


def rglru_init(rng: ParamRng, d_model: int, width: int, conv_width: int = 4,
               dtype=torch.bfloat16):
    p, a = {}, {}
    p["in_x"], a["in_x"] = dense_init(rng, d_model, width,
                                      ("embed", "ffn"), dtype)
    p["in_gate"], a["in_gate"] = dense_init(rng, d_model, width,
                                            ("embed", "ffn"), dtype)
    p["gate_a"], a["gate_a"] = dense_init(rng, width, width,
                                          ("ffn", "ffn2"), dtype, bias=True)
    p["gate_x"], a["gate_x"] = dense_init(rng, width, width,
                                          ("ffn", "ffn2"), dtype, bias=True)
    p["out"], a["out"] = dense_init(rng, width, d_model,
                                    ("ffn", "embed"), dtype)
    # Lambda init so a (at r=1) spans ~(0.9, 0.999) as in the paper:
    # a = exp(-c * softplus(Lambda)) => Lambda = log(exp(-log(a)/c) - 1)
    lam = rng.uniform((width,), 0.9, 0.999, torch.float32)
    p["lam"] = torch.log(torch.exp(-torch.log(lam) / RGLRU_C) - 1.0)
    a["lam"] = ("ffn",)
    p["conv_w"] = rng.zeros((conv_width, width), dtype)
    p["conv_w"][-1] = 1.0   # identity-ish init: current token passes through
    a["conv_w"] = (None, "ffn")
    p["conv_b"] = rng.zeros((width,), dtype)
    a["conv_b"] = ("ffn",)
    return p, a


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros_like(x))


def _sl(dim: int, start=None, stop=None, step=None) -> tuple:
    return (slice(None),) * dim + (slice(start, stop, step),)


def _interleave(a: torch.Tensor, b: torch.Tensor, dim: int) -> torch.Tensor:
    """a at the even positions of ``dim``, b at the odd ones."""
    shape = list(a.shape)
    shape[dim] = a.shape[dim] + b.shape[dim]
    out = a.new_empty(shape)
    out[_sl(dim, 0, None, 2)] = a
    out[_sl(dim, 1, None, 2)] = b
    return out


def associative_scan(combine, elems, dim: int):
    """Inclusive scan of the tuple ``elems`` along ``dim`` under the
    associative ``combine(e1, e2) -> e``, in ``jax.lax.associative_scan``'s
    order: combine adjacent pairs, scan the half-size result recursively
    (the odd positions), then combine each with the next even element, and
    interleave."""
    elems = tuple(elems)
    n = elems[0].shape[dim]
    if n < 2:
        return elems
    reduced = combine(tuple(e[_sl(dim, 0, -1, 2)] for e in elems),
                      tuple(e[_sl(dim, 1, None, 2)] for e in elems))
    odd = associative_scan(combine, reduced, dim)
    if n % 2 == 0:
        even = combine(tuple(e[_sl(dim, 0, -1)] for e in odd),
                       tuple(e[_sl(dim, 2, None, 2)] for e in elems))
    else:
        even = combine(odd, tuple(e[_sl(dim, 2, None, 2)] for e in elems))
    even = tuple(torch.cat([e[_sl(dim, 0, 1)], r], dim=dim)
                 for e, r in zip(elems, even))
    return tuple(_interleave(e, o, dim) for e, o in zip(even, odd))


def _linear_combine(e1, e2):
    a1, b1 = e1
    a2, b2 = e2
    return a2 * a1, a2 * b1 + b2


def _causal_conv(p, x: torch.Tensor, history=None) -> torch.Tensor:
    """Depthwise causal conv. x: [B, S, W]; history: [B, cw-1, W] or None.

    conv_w[j] multiplies x_{t - (cw-1) + j} (conv_w[-1] = current token).
    """
    cw = p["conv_w"].shape[0]
    if history is None:
        history = x.new_zeros((x.shape[0], cw - 1, x.shape[2]))
    xp = torch.cat([history, x], dim=1)
    out = torch.zeros_like(x)
    for j in range(cw):
        out = out + xp[:, j:j + x.shape[1]] * p["conv_w"][j]
    return out + p["conv_b"]


def _log_a(p, gated_x: torch.Tensor) -> torch.Tensor:
    r = torch.sigmoid((mm(gated_x, p["gate_a"]["w"])
                       + p["gate_a"]["b"]).to(torch.float32))
    return -RGLRU_C * _softplus(p["lam"]) * r


def _gates(p, u: torch.Tensor):
    """``(a, b)`` of the recurrence ``h = a * h + b`` for inputs u (f32)."""
    log_a = _log_a(p, u)
    a = torch.exp(log_a)
    i = torch.sigmoid((mm(u, p["gate_x"]["w"])
                       + p["gate_x"]["b"]).to(torch.float32))
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) \
        * (i * u.to(torch.float32))
    return a, b


def rglru_block(p, x: torch.Tensor, return_state: bool = False):
    """Training/prefill forward. x: [B, S, D] -> [B, S, D].

    ``return_state=True`` additionally returns the RGLRUState after the last
    token (fused prefill — no replay needed)."""
    gate_branch = gelu(mm(x, p["in_gate"]["w"]))
    u_pre = mm(x, p["in_x"]["w"])
    u = _causal_conv(p, u_pre)
    _, h = associative_scan(_linear_combine, _gates(p, u), dim=1)
    y = mm(h.to(x.dtype) * gate_branch, p["out"]["w"])
    if not return_state:
        return y
    cw = p["conv_w"].shape[0]
    s = x.shape[1]
    if s >= cw - 1:
        tail = u_pre[:, s - (cw - 1):]
    else:
        tail = torch.cat([u_pre.new_zeros(
            (x.shape[0], cw - 1 - s, u_pre.shape[-1])), u_pre], dim=1)
    return y, RGLRUState(h=h[:, -1], conv=tail)


def rglru_decode_step(p, x: torch.Tensor, state: RGLRUState):
    """x: [B, 1, D] -> ([B, 1, D], new state)."""
    gate_branch = gelu(mm(x, p["in_gate"]["w"]))
    u_t = mm(x, p["in_x"]["w"])[:, 0]                       # [B, W]

    xp = torch.cat([state.conv, u_t[:, None]], dim=1)       # [B, cw, W]
    u_c = torch.einsum("bjw,jw->bw", *promoted(xp, p["conv_w"])) \
        + p["conv_b"]
    new_conv = xp[:, 1:]

    a, b = _gates(p, u_c)
    h = a * state.h + b

    y = mm(h.to(x.dtype)[:, None] * gate_branch, p["out"]["w"])
    return y, RGLRUState(h=h, conv=new_conv)


def rglru_empty_state(batch: int, width: int, conv_width: int = 4,
                      dtype=torch.bfloat16, *, device=None) -> RGLRUState:
    """A zero state on ``device`` (the card unless the caller asks for the
    CPU)."""
    device = resolve_device(device)
    return RGLRUState(
        h=torch.zeros((batch, width), dtype=torch.float32, device=device),
        conv=torch.zeros((batch, conv_width - 1, width), dtype=dtype,
                         device=device))
