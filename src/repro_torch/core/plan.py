"""ExchangePlan -> the reducers the backends consume.

Counterpart of ``repro/core/plan.py``.
"""

from __future__ import annotations

from typing import Optional

from repro_torch.common.types import ExchangePlan
from repro_torch.core.backends.mapreduce import (
    shuffle_round_bound,
    static_capacity,
)
from repro_torch.core.spm import site_week_histogram
from repro_torch.kernels.segment_hist import (
    segment_hist_eventlog,
    segment_hist_packed_words,
)


def _kernel_word_fn(words, s_local, num_weeks, p):
    return segment_hist_packed_words(words, num_sites_local=s_local,
                                     num_partitions=p, num_weeks=num_weeks)


def resolve_histogram_fns(plan: ExchangePlan):
    """``(histogram_fn, word_histogram_fn)`` for ``plan.histogram_impl``.

    - ``histogram_fn(log, num_sites, num_weeks)``: the local combine of
      every backend and the columns exchange's reducer;
    - ``word_histogram_fn(words, s_local, num_weeks, P)``: the reducer of
      the word exchanges, or ``None`` to unpack and use ``index_add_``.

    ``"kernel"`` gives K4 (``segment_hist_eventlog``) and the fused word
    reducer K3; ``"segment_sum"`` gives ``spm.site_week_histogram``
    (``index_add_``) and ``None``.
    """
    if plan.histogram_impl == "kernel":
        return segment_hist_eventlog, _kernel_word_fn
    return site_week_histogram, None


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
