"""Feed-forward blocks: gated/plain MLPs and GShard-style MoE.

Counterpart of ``repro/models/mlp.py``. The MoE is JAX's one-hot einsum
dispatch (GShard): tokens are bucketed into groups of ``moe_group_size``;
within each group every token's top-k experts get a capacity-bounded slot;
dispatch/combine are dense [g, E, C] tensors. Capacity overflow drops
tokens and is reported in the metrics. Where JAX's semantics and torch's
defaults differ, JAX's are kept:

- the top k come from a stable descending sort, so ties go to the lower
  expert index as with ``jax.lax.top_k`` (``torch.topk`` promises no
  order on ties);
- a slot index equal to the capacity one-hot encodes to a zero row;
- dispatch is bf16 whatever the param dtype and ``combine`` is cast to
  bf16, each product running in the promoted dtype of its operands; the
  router stays f32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import ParamRng, dense_init, gelu, mm, promoted


def mlp_init(rng: ParamRng, d_model: int, d_ff: int, kind: str,
             dtype=torch.bfloat16):
    if kind in ("swiglu", "geglu"):
        p, a = {}, {}
        p["gate"], a["gate"] = dense_init(rng, d_model, d_ff,
                                          ("embed", "ffn"), dtype)
        p["up"], a["up"] = dense_init(rng, d_model, d_ff,
                                      ("embed", "ffn"), dtype)
        p["down"], a["down"] = dense_init(rng, d_ff, d_model,
                                          ("ffn", "embed"), dtype)
        return p, a
    if kind == "gelu":
        p, a = {}, {}
        p["up"], a["up"] = dense_init(rng, d_model, d_ff,
                                      ("embed", "ffn"), dtype, bias=True)
        p["down"], a["down"] = dense_init(rng, d_ff, d_model,
                                          ("ffn", "embed"), dtype, bias=True)
        return p, a
    raise ValueError(kind)


def mlp_apply(p, x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind in ("swiglu", "geglu"):
        act = F.silu if kind == "swiglu" else gelu
        h = act(mm(x, p["gate"]["w"])) * mm(x, p["up"]["w"])
        return mm(h, p["down"]["w"])
    if kind == "gelu":
        h = gelu(mm(x, p["up"]["w"]) + p["up"]["b"])
        return mm(h, p["down"]["w"]) + p["down"]["b"]
    raise ValueError(kind)


# --------------------------------------------------------------------------
# MoE
# --------------------------------------------------------------------------

def moe_init(rng: ParamRng, d_model: int, d_ff: int, num_experts: int,
             dtype=torch.bfloat16):
    scale = (1.0 / d_model) ** 0.5
    p = {
        "router": rng.normal((d_model, num_experts), scale, torch.float32),
        "gate": rng.normal((num_experts, d_model, d_ff), scale, dtype),
        "up": rng.normal((num_experts, d_model, d_ff), scale, dtype),
        "down": rng.normal((num_experts, d_ff, d_model),
                           (1.0 / d_ff) ** 0.5, dtype),
    }
    a = {
        "router": ("embed", "experts"),
        "gate": ("experts", "embed", "ffn"),
        "up": ("experts", "embed", "ffn"),
        "down": ("experts", "ffn", "embed"),
    }
    return p, a


def moe_groups(t: int, group_size: int) -> tuple:
    """``(n, g)``: the dispatch groups of ``t`` tokens and their size."""
    g = min(group_size, t)
    if t % g:
        raise ValueError(f"{t} tokens do not split into MoE groups of {g}")
    return t // g, g


def moe_route(router: torch.Tensor, xg: torch.Tensor, top_k: int):
    """The router over grouped tokens ``xg`` [n, g, D]: ``(probs, gate
    values, expert indices)``, probs [n, g, E] f32 and the top ``top_k``
    [n, g, k] in descending order, ties to the lower index; gate values
    renormalised over the k."""
    logits = torch.einsum("ngd,de->nge", xg.to(torch.float32), router)
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, expert_idx = vals[..., :top_k], idx[..., :top_k]
    gate_vals = gate_vals / torch.clamp(
        gate_vals.sum(-1, keepdim=True), min=1e-9)
    return probs, gate_vals, expert_idx


def moe_apply(p, x: torch.Tensor, *, num_experts: int, top_k: int,
              capacity_factor: float = 1.25, group_size: int = 256,
              return_metrics: bool = False):
    """GShard top-k dispatch. x: [B, S, D] -> [B, S, D].

    Tokens are reshaped into groups of ``group_size``; each group gets an
    expert capacity C = int(group * top_k * cf / E) (at least 1).
    Dropped-token fraction and router load stats are returned when
    ``return_metrics``.
    """
    b, s, d = x.shape
    t = b * s
    n, g = moe_groups(t, group_size)
    xg = x.reshape(n, g, d)
    probs, gate_vals, expert_idx = moe_route(p["router"], xg, top_k)

    capacity = max(1, int(g * top_k * capacity_factor / num_experts))

    # Sequential top-k slot assignment (k=0 has priority, GShard-style).
    dev = x.device
    dispatch = torch.zeros((n, g, num_experts, capacity),
                           dtype=torch.bfloat16, device=dev)
    combine = torch.zeros((n, g, num_experts, capacity),
                          dtype=torch.float32, device=dev)
    prior = torch.zeros((n, num_experts), dtype=torch.int32, device=dev)
    dropped = torch.zeros((), dtype=torch.float32, device=dev)
    for kk in range(top_k):
        oh = F.one_hot(expert_idx[..., kk], num_experts).to(torch.int32)
        pos = torch.cumsum(oh, dim=1, dtype=torch.int32) - 1 + prior[:, None]
        keep = (pos < capacity) & (oh > 0)
        dropped = dropped + torch.sum((oh > 0) & ~keep)
        # index == capacity encodes to a zero row, as jax.nn.one_hot does
        slot = torch.where(keep, pos, capacity).to(torch.int64)
        pos_oh = F.one_hot(slot, capacity + 1)[..., :capacity].to(
            torch.float32)                                 # [n, g, E, C]
        sel = pos_oh * oh[..., None].to(torch.float32)
        dispatch = dispatch + sel.to(torch.bfloat16)
        combine = combine + sel * gate_vals[..., kk][..., None, None]
        prior = prior + torch.sum(oh * keep, dim=1, dtype=torch.int32)

    expert_in = torch.einsum("ngec,ngd->necd", dispatch,
                             xg.to(torch.bfloat16))
    ein, w_gate = promoted(expert_in, p["gate"])
    _, w_up = promoted(expert_in, p["up"])
    h = F.silu(torch.einsum("necd,edf->necf", ein, w_gate)) \
        * torch.einsum("necd,edf->necf", ein, w_up)
    h, w_down = promoted(h, p["down"])
    expert_out = torch.einsum("necf,efd->necd", h, w_down)
    comb, expert_out = promoted(combine.to(torch.bfloat16), expert_out)
    y = torch.einsum("ngec,necd->ngd", comb, expert_out)
    y = y.reshape(b, s, d).to(x.dtype)

    if not return_metrics:
        return y
    load = torch.mean(F.one_hot(expert_idx[..., 0], num_experts).to(
        torch.float32), dim=(0, 1))
    # Switch-style load-balance loss: E * sum(load_e * mean_prob_e)
    mean_prob = torch.mean(probs, dim=(0, 1))
    aux_loss = num_experts * torch.sum(load * mean_prob)
    metrics = {
        "moe_dropped_frac": dropped / (t * top_k),
        "moe_aux_loss": aux_loss,
        "moe_top1_load_max": torch.max(load),
    }
    return y, metrics
