"""MalStone drivers over P nodes held on one device.

Counterpart of the mapreduce route of ``repro/core/runner.py``:
``malstone_run`` over a materialized log and ``malstone_run_generated``,
where the nodes generate their records in place. The JAX mesh becomes the
``nodes`` count: a flat log of ``nodes * n`` records is node-major, node d
holding records ``[d*n, (d+1)*n)``, exactly the shards a mesh of ``nodes``
devices would hold.

Both drivers run on the card unless ``device="cpu"`` is passed; with no
CUDA device and no ``device="cpu"`` they raise.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.common import nodes as nodes_lib
from repro_torch.common.types import (
    EventLog,
    ExchangePlan,
    PAD_SHARD_HASH,
    SpmResult,
    WEEKS_PER_YEAR,
)
from repro_torch.core import spm as spm_lib
from repro_torch.core.backends.mapreduce import (
    ShuffleExhaustedError,
    ShuffleStats,
    mapreduce_histogram,
    shuffle_stats,
)
from repro_torch.core.plan import resolve_word_histogram_fn

_UNPORTED_BACKENDS = ("streams", "sphere", "mapreduce_combiner")


def _check_backend(backend: str) -> None:
    if backend == "mapreduce":
        return
    if backend in _UNPORTED_BACKENDS:
        raise NotImplementedError(
            f"backend {backend!r} is not ported yet (ROADMAP.md Queue 1, "
            f"item 2); the port runs 'mapreduce'")
    raise ValueError(f"unknown backend {backend!r}")


def _raise_if_exhausted(stats: ShuffleStats) -> None:
    """An explicit ``max_shuffle_rounds`` may stop the loop with records
    undelivered: that is an error, never a silent drop."""
    undelivered = int(stats.overflow)
    if undelivered > 0:
        raise ShuffleExhaustedError(
            f"mapreduce shuffle stopped after {stats.rounds} rounds with "
            f"{undelivered} records undelivered (bucket capacity "
            f"{stats.capacity}); raise max_shuffle_rounds (None = the "
            f"provably sufficient ceil(records/capacity) bound) or "
            f"capacity_factor")


def _pad_sites(num_sites: int, parts: int) -> int:
    return ((num_sites + parts - 1) // parts) * parts


def _finalize(hist: torch.Tensor, statistic: str) -> SpmResult:
    if statistic == "A":
        return spm_lib.malstone_a(hist)
    if statistic == "B":
        return spm_lib.malstone_b(hist)
    if statistic == "B-fixed":
        return spm_lib.malstone_b_fixed_denominator(hist)
    raise ValueError(f"unknown statistic {statistic!r}")


def _local_backend_histogram(log: EventLog, s_pad: int, num_weeks: int,
                             plan: ExchangePlan):
    """Every node's mapreduce dataflow over a ``[P, n]`` log -> (the full
    ``[s_pad, W, 2]`` histogram, global ShuffleStats)."""
    owned, stats = mapreduce_histogram(
        log, s_pad, num_weeks, capacity_factor=plan.capacity_factor,
        max_rounds=plan.max_shuffle_rounds, impl=plan.impl,
        word_histogram_fn=resolve_word_histogram_fn(plan))
    return nodes_lib.all_gather_unstride(owned), shuffle_stats(stats)


def _run_nodes(log: EventLog, num_sites: int, statistic: str,
               num_weeks: int, plan: Optional[ExchangePlan],
               return_shuffle_stats: bool):
    plan = plan or ExchangePlan()
    parts = log.site_id.shape[0]
    s_pad = _pad_sites(num_sites, parts)
    hist, stats = _local_backend_histogram(log, s_pad, num_weeks, plan)
    _raise_if_exhausted(stats)
    result = _finalize(hist[:num_sites], statistic)
    return (result, stats) if return_shuffle_stats else result


def malstone_run(log: EventLog, num_sites: int, *, nodes: int,
                 statistic: str = "B", backend: str = "mapreduce",
                 num_weeks: int = WEEKS_PER_YEAR,
                 plan: Optional[ExchangePlan] = None, device=None,
                 return_shuffle_stats: bool = False):
    """Run MalStone over a flat node-major log split over ``nodes`` nodes.

    Returns the full-site ``SpmResult`` (``(SpmResult, ShuffleStats)``
    with ``return_shuffle_stats=True``). The record count must divide by
    ``nodes`` (pad with ``pad_log_to``). An exhausted explicit round cap
    raises ``ShuffleExhaustedError``.
    """
    _check_backend(backend)
    device = nodes_lib.resolve_device(device)
    if log.site_id.dim() != 1 or log.num_records % nodes:
        raise ValueError(
            f"malstone_run takes a flat log whose record count divides by "
            f"nodes={nodes}; got shape {tuple(log.site_id.shape)} (pad "
            f"with pad_log_to)")
    log = log.map(lambda c: torch.as_tensor(c, device=device)
                  .reshape(nodes, -1))
    return _run_nodes(log, num_sites, statistic, num_weeks, plan,
                      return_shuffle_stats)


def malstone_run_generated(seed, cfg, *, nodes: int, records_per_shard: int,
                           num_sites: Optional[int] = None,
                           statistic: str = "B", backend: str = "mapreduce",
                           num_weeks: int = WEEKS_PER_YEAR,
                           plan: Optional[ExchangePlan] = None,
                           device=None, return_shuffle_stats: bool = False):
    """Fused MalGen phase 3 + MalStone: every node generates its own
    shard in place (``generate_shards_device``) and the shards go straight
    into the exchange. Equal to ``malstone_run`` over the same shards
    concatenated in node order."""
    from repro_torch.malgen.generator import generate_shards_device

    _check_backend(backend)
    device = nodes_lib.resolve_device(device)
    log = generate_shards_device(seed, cfg, nodes, records_per_shard,
                                 device=device)
    return _run_nodes(log, num_sites or cfg.num_sites, statistic, num_weeks,
                      plan, return_shuffle_stats)


def pad_log_to(log: EventLog, target: int) -> EventLog:
    """Pad a flat log with invalid rows up to ``target`` records."""
    n = log.num_records
    pad = target - n
    if pad < 0:
        raise ValueError(
            f"pad_log_to target ({target}) is smaller than the log's record "
            f"count ({n}); pass a target >= num_records")
    valid = log.valid_mask()
    if pad == 0:
        return log._replace(valid=valid)

    def padcol(x, fill=0):
        return torch.cat([x, torch.full((pad,), fill, dtype=x.dtype,
                                        device=x.device)])

    return EventLog(
        site_id=padcol(log.site_id), entity_id=padcol(log.entity_id),
        timestamp=padcol(log.timestamp), mark=padcol(log.mark),
        event_seq=None if log.event_seq is None else padcol(log.event_seq),
        shard_hash=None if log.shard_hash is None
        else padcol(log.shard_hash, fill=PAD_SHARD_HASH),
        valid=padcol(valid, fill=False))
