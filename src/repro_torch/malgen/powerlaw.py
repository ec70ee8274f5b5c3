"""Power-law site popularity and inverse-CDF site sampling (paper §5).

Counterpart of ``repro/malgen/powerlaw.py``. Site ``i`` gets weight
``(rank+1)^-alpha`` after a random permutation; sampling searches a
uniform draw in the stored cumulative table (on the card through K6).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.powerlaw_sample.ops import powerlaw_sample


def power_law_weights(num_sites: int, alpha: float = 1.2,
                      permutation: Optional[torch.Tensor] = None,
                      device=None) -> torch.Tensor:
    """Normalized float32 weights ``[num_sites]``; heavy head, long tail."""
    if permutation is not None:
        device = permutation.device
    ranks = torch.arange(1, num_sites + 1, dtype=torch.float32,
                         device=device)
    w = ranks ** (-alpha)
    w = w / w.sum()
    if permutation is not None:
        w = w[permutation]
    return w


def power_law_cdf(weights: torch.Tensor) -> torch.Tensor:
    """Inclusive cumulative sum of float32 ``weights``, renormalized so
    the last entry is 1. Scanned on the CPU for the reason
    ``masked_site_cdf`` gives, then moved to the weights' device."""
    cdf = torch.cumsum(weights.to(torch.float32).cpu(), dim=0)
    return (cdf / cdf[-1]).to(weights.device)


def masked_site_cdf(weights: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    """Normalized inclusive CDF of ``weights`` restricted to ``mask``.
    Seed data: computed once and stored, never per generation call.

    The scan runs on the CPU, which adds in index order: a float32 scan on
    the card (CUB's decoupled look-back) may associate the partial sums
    differently from one run to the next, and the table must be a pure
    function of its inputs, or one seed would give other records each
    time."""
    w = torch.where(mask, weights, torch.zeros_like(weights)).cpu()
    cdf = torch.cumsum(w, dim=0)
    return (cdf / torch.clamp(cdf[-1], min=1e-30)).to(weights.device)


def sample_sites(cdf: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Inverse-CDF sampling of the uniform draws ``u``: int32 site
    indices, ``searchsorted(cdf, u, right)`` clamped to ``[0, S-1]``
    (the JAX ``jnp.searchsorted(..., side="right")`` at powerlaw.py:38).

    On a CUDA ``cdf`` the draws go through K6 (``powerlaw_sample``), which
    computes the same function; an empty ``u`` launches nothing. On the CPU
    it is ``torch.searchsorted``, the JAX function's own counterpart."""
    u = u.to(cdf.device)
    if cdf.device.type == "cuda":
        if u.numel() == 0:
            return torch.empty(u.shape, dtype=torch.int32, device=u.device)
        return powerlaw_sample(u.reshape(-1).contiguous(), cdf).reshape(
            u.shape)
    idx = torch.searchsorted(cdf, u, right=True)
    return idx.clamp(0, cdf.shape[0] - 1).to(torch.int32)
