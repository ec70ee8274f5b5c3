"""Stable-argsort oracle of the counting sort.

A stable counting sort produces the same permutation as a stable argsort by
destination followed by a gather, and its segment starts equal a
``searchsorted`` of the sorted destinations. This is that formulation,
batched over rows; the MapReduce ``"sort"`` exchange uses it, and the
tests hold ``count_scatter`` against it.
"""

from __future__ import annotations

import torch


def count_scatter_ref(words: torch.Tensor, dest: torch.Tensor,
                      num_partitions: int):
    """``(words_sorted, starts)`` of each row: ``words`` gathered in stable
    argsort order of ``dest``, and int32 ``[B, P+1]`` starts."""
    order = torch.argsort(dest, dim=-1, stable=True)
    dest_sorted = dest.gather(-1, order).contiguous()
    keys = torch.arange(num_partitions + 1, dtype=dest.dtype,
                        device=dest.device).expand(dest.shape[0], -1)
    starts = torch.searchsorted(dest_sorted, keys.contiguous())
    return words.gather(-1, order), starts.to(torch.int32)
