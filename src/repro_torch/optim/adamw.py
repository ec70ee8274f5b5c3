"""AdamW with global-norm clipping, on trees of tensors.

Counterpart of ``repro/optim/adamw.py``, and functional as it is: an
update returns new trees and leaves its inputs alone. Moments are float32
by default; ``moment_dtype="bfloat16"`` stores them in bf16 (half the
optimizer memory), while every update computes in float32 and casts the
moments back. Weight decay is decoupled and applies to leaves with two or
more dimensions only.

Scalars that divide (the clip threshold, 1 - b^t) are 0-dim tensors on
the leaves' device, so the card divides as IEEE does: PyTorch's CUDA
division by a Python number multiplies by its reciprocal, and
``number / tensor`` is a reciprocal times the number.

Memory: a leaf of more than ``CHUNK_ELEMS`` elements (a stacked layer
group, a stack of experts, an embedding table) is updated a block of
leading rows at a time, so the f32 temporaries of the update are a
block's, not the leaf's (the update is elementwise: the same values). With ``consume_grads=True`` and ``grads`` a list of
leaves, each gradient is dropped from the list once its leaf is updated,
so a caller that holds no other reference frees it there: the old state,
the new state and the gradients are then never all alive at once.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.common import tree as tr

_MOMENT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# the most elements a leaf's update takes at once (64 MB of f32)
CHUNK_ELEMS = 1 << 24


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"    # "float32" | "bfloat16"


class OptState(NamedTuple):
    step: torch.Tensor   # 0-dim int32
    mu: Any              # first moment (params-shaped)
    nu: Any              # second moment


def _device_of(tree) -> torch.device:
    leaves = tr.tree_leaves(tree)
    return leaves[0].device if leaves else torch.device("cpu")


def adamw_init(params, cfg: AdamWConfig) -> OptState:
    if cfg.moment_dtype not in _MOMENT_DTYPES:
        raise ValueError(f"moment_dtype {cfg.moment_dtype!r}: one of "
                         f"{sorted(_MOMENT_DTYPES)}")
    dt = _MOMENT_DTYPES[cfg.moment_dtype]
    return OptState(
        step=torch.zeros((), dtype=torch.int32, device=_device_of(params)),
        mu=tr.tree_zeros_like(params, dt),
        nu=tr.tree_zeros_like(params, dt),
    )


def adamw_update(params, grads, state: OptState, cfg: AdamWConfig,
                 lr_scale=1.0, *, consume_grads: bool = False):
    """One AdamW step. Returns ``(new_params, new_state, metrics)``;
    ``metrics`` holds the f32 ``grad_norm`` (before clipping) and
    ``lr``. ``grads`` is a tree like ``params`` or the list of its leaves
    in flattening order; ``consume_grads`` empties that list (see the
    module docstring)."""
    device = state.step.device
    flat_g = grads if consume_grads else tr.tree_leaves(grads)
    if consume_grads and not isinstance(flat_g, list):
        raise ValueError("consume_grads needs the gradients as a list")
    gnorm = tr.tree_global_norm(flat_g).to(device)
    clip = (torch.clamp(torch.full_like(gnorm, cfg.grad_clip)
                        / torch.clamp(gnorm, min=1e-9), max=1.0)
            if cfg.grad_clip > 0 else torch.ones((), device=device))
    step = state.step + 1
    b1c = 1.0 - cfg.b1 ** step.to(torch.float32)
    b2c = 1.0 - cfg.b2 ** step.to(torch.float32)
    lr = cfg.lr * lr_scale

    def upd(p, g, mu, nu, decay: bool):
        gf = g.to(torch.float32) * clip
        mu_n = cfg.b1 * mu.to(torch.float32) + (1 - cfg.b1) * gf
        nu_n = cfg.b2 * nu.to(torch.float32) + (1 - cfg.b2) * torch.square(gf)
        mu_hat = mu_n / b1c
        nu_hat = nu_n / b2c
        delta = mu_hat / (torch.sqrt(nu_hat) + cfg.eps)
        if decay:
            delta = delta + cfg.weight_decay * p.to(torch.float32)
        p_n = p.to(torch.float32) - lr * delta
        return p_n.to(p.dtype), mu_n.to(mu.dtype), nu_n.to(nu.dtype)

    def leaf(p, g, mu, nu):
        decay = cfg.weight_decay > 0 and p.ndim >= 2   # decay matrices only
        if p.numel() <= CHUNK_ELEMS:
            return upd(p, g, mu, nu, decay)
        rows = max(1, CHUNK_ELEMS * p.shape[0] // p.numel())
        out = tuple(torch.empty_like(x) for x in (p, mu, nu))
        for i in range(0, p.shape[0], rows):
            sl = slice(i, i + rows)
            for o, x in zip(out, upd(p[sl], g[sl], mu[sl], nu[sl], decay)):
                o[sl] = x
        return out

    p_leaves = tr.tree_leaves(params)
    if len(flat_g) != len(p_leaves):
        raise ValueError(f"{len(flat_g)} gradients for {len(p_leaves)} "
                         f"parameters")
    mu_leaves, nu_leaves = tr.tree_leaves(state.mu), tr.tree_leaves(state.nu)
    out = [None] * len(p_leaves)
    # the largest leaves first: the last gradient still alive when the
    # new state is almost whole is then a small one
    for i in sorted(range(len(p_leaves)), key=lambda j: -p_leaves[j].numel()):
        g = flat_g[i]
        if consume_grads:
            flat_g[i] = None
        out[i] = leaf(p_leaves[i], g, mu_leaves[i], nu_leaves[i])
        del g
    new_p, new_mu, new_nu = (tr.tree_unflatten(like, [o[i] for o in out])
                             for i, like in enumerate(
                                 (params, state.mu, state.nu)))
    lr = (lr.to(torch.float32) if isinstance(lr, torch.Tensor)
          else torch.full((), lr, dtype=torch.float32, device=device))
    metrics = {"grad_norm": gnorm, "lr": lr}
    return new_p, OptState(step=step, mu=new_mu, nu=new_nu), metrics
