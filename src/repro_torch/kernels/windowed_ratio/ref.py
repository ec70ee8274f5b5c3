"""Oracles of the window ratios, the JAX package's ``windowed_ratio_ref``
(int32 cumsums plus ``safe_ratio``: MalStone B) and
``masked_window_ratio_ref`` (an int32 contraction plus ``safe_ratio``).
Integer matrix products run only on the CPU in PyTorch, so the masked
oracle is for CPU tensors; the wrappers' plain versions run on both."""

from __future__ import annotations

import torch

from repro_torch.common.types import safe_ratio


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    return (torch.remainder(x + 2**31, 2**32) - 2**31).to(torch.int32)


def masked_window_ratio_ref(hist: torch.Tensor, num_masks: torch.Tensor,
                            den_masks: torch.Tensor):
    """hist int32 ``[S, W, 2]``, masks bool ``[N, W]`` -> (rho f32, num
    i32, den i32), each ``[N, S]``; the sums wrap as int32 sums do."""
    num = _wrap32(num_masks.to(torch.int64) @ hist[..., 1].to(torch.int64).T)
    den = _wrap32(den_masks.to(torch.int64) @ hist[..., 0].to(torch.int64).T)
    return safe_ratio(num, den), num, den


def windowed_ratio_ref(hist: torch.Tensor):
    """hist int32 ``[S, W, 2]`` -> (rho f32, cum_total i32, cum_marked
    i32), each ``[S, W]``; the running sums wrap as int32 sums do."""
    cum_total = torch.cumsum(hist[..., 0], dim=-1, dtype=torch.int32)
    cum_marked = torch.cumsum(hist[..., 1], dim=-1, dtype=torch.int32)
    return safe_ratio(cum_marked, cum_total), cum_total, cum_marked
