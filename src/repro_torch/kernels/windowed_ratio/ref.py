"""Oracle of the masked window ratio: the JAX package's
``masked_window_ratio_ref`` (an int32 contraction plus ``safe_ratio``).
Integer matrix products run only on the CPU in PyTorch, so this oracle is
for CPU tensors; the wrapper's plain version runs on both."""

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
