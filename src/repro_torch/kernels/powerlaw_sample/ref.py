"""Oracle of the power-law site sampler: the JAX package's
``powerlaw_sample_ref``, ``searchsorted(cdf, u, side="right")`` clipped to
``[0, S-1]``. A NaN draw sorts last and gives ``S - 1``."""

from __future__ import annotations

import torch


def powerlaw_sample_ref(u: torch.Tensor, cdf: torch.Tensor) -> torch.Tensor:
    """f32 draws ``u`` and the f32 inclusive CDF ``[S]`` -> int32 site
    indices of ``u``'s flattened shape."""
    idx = torch.searchsorted(cdf, u.reshape(-1), right=True)
    return idx.clamp(0, cdf.shape[0] - 1).to(torch.int32)
