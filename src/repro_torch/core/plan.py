"""ExchangePlan -> the reducer the MapReduce backend consumes.

Counterpart of ``repro/core/plan.py``.
"""

from __future__ import annotations

from typing import Optional

from repro_torch.common.types import ExchangePlan
from repro_torch.core.backends.mapreduce import (
    shuffle_round_bound,
    static_capacity,
)
from repro_torch.kernels.segment_hist import segment_hist_packed_words


def _kernel_word_fn(words, s_local, num_weeks, p):
    return segment_hist_packed_words(words, num_sites_local=s_local,
                                     num_partitions=p, num_weeks=num_weeks)


def resolve_word_histogram_fn(plan: ExchangePlan):
    """The ``word_histogram_fn`` for ``plan.histogram_impl`` (the JAX
    package's ``resolve_histogram_fns``).

    ``"kernel"`` gives the fused word reducer K3; ``"segment_sum"`` gives
    ``None``, so the shipped words are unpacked and reduced with
    ``index_add_``.
    """
    return _kernel_word_fn if plan.histogram_impl == "kernel" else None


def expected_shuffle_rounds(plan: Optional[ExchangePlan],
                            shard_records: int, parts: int) -> int:
    """The round bound the exchange loop runs under: an explicit
    ``plan.max_shuffle_rounds``, else ``ceil(shard_records / capacity)``."""
    plan = plan or ExchangePlan()
    if plan.max_shuffle_rounds is not None:
        return plan.max_shuffle_rounds
    return shuffle_round_bound(
        shard_records,
        static_capacity(shard_records, parts, plan.capacity_factor))
