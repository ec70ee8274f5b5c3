"""Plain (site, week, mark, valid) -> (total, marked) histogram.

Twin of the JAX package's ``segment_hist_ref``, batched over leading rows:
columns of shape ``[B, n]`` give int32 ``[B, num_sites, num_weeks, 2]``.
Rows that are invalid or out of range count nowhere.
"""

from __future__ import annotations

import torch


def segment_hist_ref(site: torch.Tensor, week: torch.Tensor,
                     mark: torch.Tensor, valid: torch.Tensor,
                     num_sites: int, num_weeks: int) -> torch.Tensor:
    b = site.shape[0]
    ok = ((valid > 0) & (site >= 0) & (site < num_sites)
          & (week >= 0) & (week < num_weeks))
    row = torch.arange(b, device=site.device).unsqueeze(1)
    flat = ((row * num_sites + site) * num_weeks + week).masked_fill(~ok, 0)
    payload = torch.stack([ok, ok & (mark > 0)], dim=-1).to(torch.int32)
    hist = torch.zeros(b * num_sites * num_weeks, 2, dtype=torch.int32,
                       device=site.device)
    hist.index_add_(0, flat.reshape(-1), payload.reshape(-1, 2))
    return hist.reshape(b, num_sites, num_weeks, 2)
