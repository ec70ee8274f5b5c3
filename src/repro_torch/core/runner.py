"""MalStone drivers over P nodes held on one device.

Counterpart of the drivers of ``repro/core/runner.py``: ``malstone_run``
over a materialized log, ``malstone_run_partitioned`` (the same, with the
result left split by site block), ``malstone_run_generated``, where the
nodes generate their records in place, and the chunked streaming drivers
``malstone_run_streaming`` (over a log, or regenerating chunks from a
streaming seed) and ``malstone_run_generated_streaming``. Each runs any
of the four backends (``streams``, ``sphere``, ``mapreduce``,
``mapreduce_combiner``); the port's default is
``mapreduce``, the JAX package's ``streams`` (``sphere`` when
partitioned). The JAX mesh becomes the ``nodes`` count: a flat log of
``nodes * n`` records is node-major, node d holding records ``[d*n,
(d+1)*n)``, exactly the shards a mesh of ``nodes`` devices would hold.

The drivers run on the card unless ``device="cpu"`` is passed; with no
CUDA device and no ``device="cpu"`` they raise. ``malstone_single_device``
is the plain one-device oracle they are checked against.

``malstone_run``, ``malstone_run_partitioned`` and
``malstone_run_streaming`` take a ``group`` (a
``repro_torch.common.nodes.NodeGroup``, the counterpart of a JAX mesh that
spans processes): in a gang each process runs the dataflow of its own
``nodes / N`` nodes, the collectives run over the gang, and every process
finalizes the full histogram (JAX's rho is replicated on every process
too). ``nodes`` stays the global P and a log source stays the global flat
log, of which a process keeps its own nodes' rows. The default is one
process with every node.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.common import nodes as nodes_lib
from repro_torch.common import trace
from repro_torch.common.types import (
    EventLog,
    ExchangePlan,
    PAD_SHARD_HASH,
    SpmResult,
    WEEKS_PER_YEAR,
)
from repro_torch.core import spm as spm_lib
from repro_torch.core.backends import (
    BACKENDS,
    ShuffleExhaustedError,
    ShuffleStats,
    mapreduce_combiner_histogram,
    mapreduce_histogram,
    shuffle_stats,
    sphere_histogram,
    streams_histogram,
)
from repro_torch.core.plan import resolve_histogram_fns

RUN_BACKENDS = BACKENDS + ("mapreduce_combiner",)


def _check_backend(backend: str) -> None:
    if backend not in RUN_BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; have {RUN_BACKENDS}")


def _raise_if_exhausted(stats: Optional[ShuffleStats]) -> None:
    """An explicit ``max_shuffle_rounds`` may stop the loop with records
    undelivered: that is an error, never a silent drop."""
    if stats is None:
        return
    undelivered = trace.host_read(stats.overflow, "overflow")
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
    with trace.span("run.finalize"):
        if statistic == "A":
            return spm_lib.malstone_a(hist)
        if statistic == "B":
            return spm_lib.malstone_b(hist)
        if statistic == "B-fixed":
            return spm_lib.malstone_b_fixed_denominator(hist)
    raise ValueError(f"unknown statistic {statistic!r}")


def _local_backend_histogram(log: EventLog, backend: str, s_pad: int,
                             num_weeks: int, plan: ExchangePlan,
                             group: nodes_lib.NodeGroup):
    """The backend dataflow of the group's nodes over their ``[P_local,
    n]`` log -> (the full ``[s_pad, W, 2]`` histogram, global ShuffleStats
    for ``mapreduce``, else ``None``), the same on every process."""
    hist_fn, word_fn = resolve_histogram_fns(plan)
    if backend == "streams":
        return streams_histogram(log, s_pad, num_weeks, histogram_fn=hist_fn,
                                 group=group), None
    if backend == "sphere":
        # owned contiguous blocks, gathered back to the full histogram
        return nodes_lib.all_gather(sphere_histogram(
            log, s_pad, num_weeks, histogram_fn=hist_fn, group=group),
            group), None
    stats = None
    if backend == "mapreduce":
        owned, stats = mapreduce_histogram(
            log, s_pad, num_weeks, capacity_factor=plan.capacity_factor,
            max_rounds=plan.max_shuffle_rounds, impl=plan.impl,
            histogram_fn=hist_fn, word_histogram_fn=word_fn, group=group)
        stats = shuffle_stats(stats, group)
    elif backend == "mapreduce_combiner":
        owned = mapreduce_combiner_histogram(log, s_pad, num_weeks,
                                             histogram_fn=hist_fn,
                                             group=group)
    else:
        raise ValueError(f"unknown backend {backend!r}")
    # owned rows are strided (site = row * P + d): gather + unstride
    return nodes_lib.all_gather_unstride(owned, group), stats


def _run_nodes(log: EventLog, num_sites: int, statistic: str, backend: str,
               num_weeks: int, plan: Optional[ExchangePlan],
               return_shuffle_stats: bool,
               group: Optional[nodes_lib.NodeGroup] = None):
    plan = plan or ExchangePlan()
    group = group or nodes_lib.NodeGroup(log.site_id.shape[0])
    s_pad = _pad_sites(num_sites, group.nodes)
    hist, stats = _local_backend_histogram(log, backend, s_pad, num_weeks,
                                           plan, group)
    _raise_if_exhausted(stats)
    result = _finalize(hist[:num_sites], statistic)
    return (result, stats) if return_shuffle_stats else result


def _node_log(log: EventLog, group: nodes_lib.NodeGroup,
              device) -> EventLog:
    """The group's ``[P_local, n]`` rows of a flat node-major log of
    ``group.nodes`` nodes, on ``device``."""
    if log.site_id.dim() != 1 or log.num_records % group.nodes:
        raise ValueError(
            f"the drivers take a flat log whose record count divides by "
            f"nodes={group.nodes}; got shape {tuple(log.site_id.shape)} "
            f"(pad with pad_log_to)")
    return log.map(lambda c: torch.as_tensor(group.rows(c), device=device))


def malstone_run(log: EventLog, num_sites: int, *, nodes: int,
                 statistic: str = "B", backend: str = "mapreduce",
                 num_weeks: int = WEEKS_PER_YEAR,
                 plan: Optional[ExchangePlan] = None, device=None,
                 return_shuffle_stats: bool = False,
                 group: Optional[nodes_lib.NodeGroup] = None):
    """Run MalStone over a flat node-major log split over ``nodes`` nodes
    (of which ``group``, default all of them, runs here).

    Returns the full-site ``SpmResult`` (``(SpmResult, ShuffleStats)``
    with ``return_shuffle_stats=True``; the stats are ``None`` for the
    backends other than ``mapreduce``, which shuffle no records). The
    record count must divide by ``nodes`` (pad with ``pad_log_to``). An
    exhausted explicit round cap raises ``ShuffleExhaustedError``.
    """
    _check_backend(backend)
    device = nodes_lib.resolve_device(device)
    group = nodes_lib.group_of(group, nodes)
    return _run_nodes(_node_log(log, group, device), num_sites, statistic,
                      backend, num_weeks, plan, return_shuffle_stats, group)


def malstone_run_partitioned(log: EventLog, num_sites: int, *, nodes: int,
                             statistic: str = "B",
                             backend: str = "mapreduce",
                             num_weeks: int = WEEKS_PER_YEAR,
                             plan: Optional[ExchangePlan] = None,
                             device=None,
                             return_shuffle_stats: bool = False,
                             group: Optional[nodes_lib.NodeGroup] = None):
    """``malstone_run`` with the result left partitioned by site block:
    every array of the ``SpmResult`` has a leading ``[P_local, s_pad /
    nodes]`` axis, node d owning sites ``[d * s_pad/P, (d+1) * s_pad/P)``
    of the padded site range ``s_pad = ceil(num_sites / P) * P`` (a
    process of a gang holds its own nodes' blocks). The blocks joined in
    node order give JAX's ``malstone_run_partitioned`` result, padding
    included.

    ``sphere`` finalizes its owned blocks and never makes the full-site
    histogram; the other backends cut their full histogram into blocks.
    """
    _check_backend(backend)
    device = nodes_lib.resolve_device(device)
    group = nodes_lib.group_of(group, nodes)
    log = _node_log(log, group, device)
    plan = plan or ExchangePlan()
    s_pad = _pad_sites(num_sites, nodes)
    if backend == "sphere":
        hist_fn, _ = resolve_histogram_fns(plan)
        owned = sphere_histogram(log, s_pad, num_weeks, histogram_fn=hist_fn,
                                 group=group)
        stats = None
    else:
        hist, stats = _local_backend_histogram(log, backend, s_pad,
                                               num_weeks, plan, group)
        _raise_if_exhausted(stats)
        owned = group.rows(hist).reshape(group.local, s_pad // nodes,
                                         *hist.shape[1:])
    result = _finalize(owned, statistic)
    return (result, stats) if return_shuffle_stats else result


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
    return _run_nodes(log, num_sites or cfg.num_sites, statistic, backend,
                      num_weeks, plan, return_shuffle_stats)


def malstone_single_device(log: EventLog, num_sites: int,
                           statistic: str = "B",
                           num_weeks: int = WEEKS_PER_YEAR,
                           histogram_fn=None) -> SpmResult:
    """Reference single-device path (the "fits in a database" case of §1):
    the plain ``spm.site_week_histogram`` of a flat log, then the
    finalizer, on the device the log lies on.

    On a CUDA log the B finalizer runs K7 (``core/spm.py:malstone_b``), so
    an oracle meant to share no kernel with the run it checks is handed a
    CPU copy of the log, as the launcher's ``--check`` does."""
    hist_fn = histogram_fn or spm_lib.site_week_histogram
    hist = hist_fn(log, num_sites, num_weeks)
    return _finalize(hist, statistic)


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


def malstone_run_streaming(seed_or_log, num_sites: int, *, nodes: int,
                           backend: str = "mapreduce",
                           chunk_records: int = 65_536,
                           statistic: str = "B", cfg=None,
                           num_chunks: Optional[int] = None,
                           num_weeks: int = WEEKS_PER_YEAR,
                           plan: Optional[ExchangePlan] = None, device=None,
                           return_shuffle_stats: bool = False,
                           overlap: Optional[bool] = None,
                           group: Optional[nodes_lib.NodeGroup] = None):
    """Streaming chunked MalStone (``core.streaming``): the histogram equals
    ``malstone_run``'s for every backend; mapreduce's ShuffleStats
    accumulate over the per-chunk shuffles, ``rounds`` being the most any
    chunk needed. ``group`` (default: every node here) picks the nodes
    this process folds.

    - A ``SeedInfo`` from ``make_seed_streaming`` (needs ``cfg`` and
      ``num_chunks``, which must divide by ``nodes``): every step
      regenerates its chunks, node d folding chunks ``[d * cpn, (d+1) *
      cpn)``. Its one-shot oracle is ``malstone_run`` over
      ``generate_chunked_log(seed, cfg, num_chunks, chunk_records)``.
    - An ``EventLog`` (flat, node-major): padded with invalid rows so every
      node folds whole chunks.

    ``overlap`` picks how seed mode runs: ``None`` (default) is the loop
    above; ``True`` / ``False`` go through
    :class:`~repro_torch.core.overlap.OverlapStreamingRunner` (on the card,
    on: chunk k+1 generated on a second CUDA stream while chunk k is
    exchanged and reduced; off: the same calls, synchronised after each).
    All three give the same histogram, rho bits and ShuffleStats. Timing
    loops should hold their own runner (this path builds one per call).
    """
    from repro_torch.core.streaming import (
        streaming_histogram_from_log,
        streaming_histogram_generate,
    )
    from repro_torch.malgen.seeding import SeedInfo

    _check_backend(backend)
    if overlap is not None and not isinstance(seed_or_log, SeedInfo):
        raise ValueError(
            "overlap= requires seed-mode streaming (a SeedInfo source);"
            " the log path has no generation stage to pipeline")
    if chunk_records < 1:
        raise ValueError(f"chunk_records must be >= 1, got {chunk_records}")
    device = nodes_lib.resolve_device(device)
    group = nodes_lib.group_of(group, nodes)
    plan = plan or ExchangePlan()
    s_pad = _pad_sites(num_sites, nodes)
    if isinstance(seed_or_log, SeedInfo):
        if cfg is None or num_chunks is None:
            raise ValueError("seed mode requires cfg= and num_chunks=")
        if num_chunks % nodes:
            raise ValueError(f"num_chunks ({num_chunks}) must divide over "
                             f"the {nodes} nodes")
        if overlap is not None:
            from repro_torch.core.overlap import OverlapStreamingRunner

            runner = OverlapStreamingRunner(
                seed_or_log, cfg, nodes=nodes, num_chunks=num_chunks,
                chunk_records=chunk_records, num_sites=num_sites,
                backend=backend, num_weeks=num_weeks, plan=plan,
                device=device, group=group)
            result, stats = runner.run_result(statistic, overlap=overlap)
            return (result, stats) if return_shuffle_stats else result
        hist, stats = streaming_histogram_generate(
            seed_or_log.to(device), cfg, s_pad, parts=nodes,
            chunks_per_node=num_chunks // nodes, chunk_records=chunk_records,
            num_weeks=num_weeks, backend=backend, plan=plan, group=group)
    else:
        log = seed_or_log
        per_node = -(-log.num_records // (nodes * chunk_records)) \
            * chunk_records
        log = _node_log(pad_log_to(log, per_node * nodes), group, device)
        hist, stats = streaming_histogram_from_log(
            log, s_pad, chunk_records, num_weeks=num_weeks, backend=backend,
            plan=plan, group=group)
    _raise_if_exhausted(stats)
    result = _finalize(hist[:num_sites], statistic)
    return (result, stats) if return_shuffle_stats else result


def malstone_run_generated_streaming(seed, cfg, *, nodes: int,
                                     records_per_shard: int,
                                     chunk_records: int = 65_536,
                                     num_sites: Optional[int] = None,
                                     statistic: str = "B",
                                     backend: str = "mapreduce",
                                     num_weeks: int = WEEKS_PER_YEAR,
                                     plan: Optional[ExchangePlan] = None,
                                     device=None,
                                     return_shuffle_stats: bool = False):
    """Streaming twin of ``malstone_run_generated``: every node generates
    its shard in place (``generate_shards_device``), then folds it in
    chunks. Equal to ``malstone_run_streaming`` over the same shards as a
    log at the same ``chunk_records``, which must divide
    ``records_per_shard`` (no padding rows are generated)."""
    from repro_torch.core.streaming import streaming_histogram_from_log
    from repro_torch.malgen.generator import generate_shards_device

    _check_backend(backend)
    if chunk_records < 1 or records_per_shard % chunk_records:
        raise ValueError(
            f"records_per_shard ({records_per_shard}) must be divisible by "
            f"chunk_records ({chunk_records}) on the generated streaming "
            f"path (no padding rows are generated)")
    device = nodes_lib.resolve_device(device)
    num_sites = num_sites or cfg.num_sites
    log = generate_shards_device(seed, cfg, nodes, records_per_shard,
                                 device=device)
    hist, stats = streaming_histogram_from_log(
        log, _pad_sites(num_sites, nodes), chunk_records,
        num_weeks=num_weeks, backend=backend, plan=plan)
    _raise_if_exhausted(stats)
    result = _finalize(hist[:num_sites], statistic)
    return (result, stats) if return_shuffle_stats else result
