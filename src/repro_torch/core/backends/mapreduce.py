"""Hadoop-MapReduce-analogue backend: the paper's record shuffle (§6.1).

Counterpart of ``repro/core/backends/mapreduce.py``. Node d owns the
strided sites ``{j : j % P == d}``; its histogram rows are ``site // P``.
Three exchanges ship every record to its owner, all lossless:

- ``"counting"`` and ``"sort"``: every record is projected to one int32
  word, the words of each node are ordered by destination ``site % P``
  once, and a multi-round loop ships the next ``capacity``-wide window of
  every destination segment until no record is left;
- ``"columns"``: each round orders the pending records by destination,
  ships the first ``capacity`` of each destination as four int32 columns
  plus validity, and keeps the rest in a same-shape residual log for the
  next round (the fallback for workloads the word cannot represent).

A round's shipped words are written in one pass (K9, ``kernels/
ship_buckets``); in a gang, in the senders' layout the ``all_to_all``
ships.

``mapreduce_combiner_histogram`` is MapReduce with a combiner: each node
pre-reduces its records and only strided histogram blocks are shuffled;
one process exchanges and sums them in one pass (K8, ``kernels/
combine_blocks``).

A process's nodes are axis 0 of every tensor (``repro_torch.common.
nodes``): one tensor op or one kernel launch serves all of them, the
``all_to_all`` is a transpose and the ``psum`` a sum over axis 0. The loop
tests the global leftover count on the host once per round, where the JAX
package tests it in its ``while_loop`` condition.

Every function takes a ``group`` (``NodeGroup``; default: one process with
every node). In a gang of processes a process holds the rows of its own
nodes, while the destinations, the site striding and the bucket bytes stay
those of all P nodes; the leftover count a round loop tests is summed over
the whole gang, so every process runs the same rounds and makes the same
collectives.

``ShuffleStats`` per node are int32 ``[P_local]`` tensors
(``shuffle_stats`` sums them over all nodes); ``capacity`` and ``rounds``
are the same on every node and are Python ints. ``bytes_exchanged``
follows the JAX package's int32 saturation rule (x64 off), so every field
matches it.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple, Optional

import torch

from repro_torch.common import nodes, trace
from repro_torch.common.types import (
    EXCHANGE_IMPLS,
    EventLog,
    PACK_MAX_SITES,
    PACK_MAX_WEEKS,
    SECONDS_PER_WEEK,
    WEEKS_PER_YEAR,
    pack_site_week_mark,
    unpack_site_week_mark,
)
from repro_torch.core.spm import site_week_histogram
from repro_torch.kernels.combine_blocks import (
    combine_blocks,
    combine_blocks_plain,
)
from repro_torch.kernels.count_scatter import count_scatter, count_scatter_ref
from repro_torch.kernels.ship_buckets import ship_buckets

# Bytes one bucket slot occupies on the wire per shuffle round.
PACKED_SLOT_BYTES = 4        # one word
UNPACKED_SLOT_BYTES = 17     # four int32 columns + one bool validity column
_INT32_MAX = 2**31 - 1


class ShuffleExhaustedError(RuntimeError):
    """``max_rounds`` shuffle rounds ran and records remain undelivered."""


class ShuffleStats(NamedTuple):
    """Shuffle accounting (fields as in the JAX package):

    - ``sent``: records delivered to their reducer, summed over rounds;
    - ``overflow``: records still undelivered when the loop stopped
      (0 means lossless);
    - ``capacity``: per-destination bucket capacity of each round;
    - ``rounds``: rounds run;
    - ``residual``: sum over rounds of the records left for later rounds;
    - ``bytes_exchanged``: bucket bytes shipped, ``rounds x P x capacity
      x slot bytes`` per node (4 for a word, 17 for the columns), int32,
      saturating at 2^31 - 1 instead of wrapping.
    """

    sent: torch.Tensor
    overflow: torch.Tensor
    capacity: int
    rounds: int
    residual: torch.Tensor
    bytes_exchanged: torch.Tensor


def static_capacity(num_records: int, parts: int,
                    capacity_factor: float) -> int:
    """Per-destination bucket capacity for a per-node record count (Python
    ``round``, halves to even, as in the JAX package)."""
    return int(max(1, round(num_records / parts * capacity_factor)))


def shuffle_round_bound(num_records: int, capacity: int) -> int:
    """Rounds that provably drain any skew: a node holds at most
    ``num_records`` records for one destination."""
    return max(1, -(-num_records // capacity))


def packed_shuffle_supported(num_sites: int, num_weeks: int) -> bool:
    """Whether the one-word projection can represent the workload."""
    return num_sites <= PACK_MAX_SITES and num_weeks <= PACK_MAX_WEEKS


def resolve_exchange_impl(impl: str, num_sites: int, num_weeks: int) -> str:
    """``"auto"`` -> ``"counting"`` when the word can represent the
    workload, else ``"columns"``. Forcing a word impl (``"sort"`` or
    ``"counting"``) on a workload it cannot represent is an error, never a
    silent fallback."""
    if impl not in EXCHANGE_IMPLS:
        raise ValueError(
            f"exchange impl must be one of {EXCHANGE_IMPLS}, got {impl!r}")
    supported = packed_shuffle_supported(num_sites, num_weeks)
    if impl == "auto":
        return "counting" if supported else "columns"
    if impl != "columns" and not supported:
        raise ValueError(
            f"exchange impl {impl!r} requested but the one-word projection "
            f"cannot represent num_sites={num_sites} (max {PACK_MAX_SITES}) "
            f"/ num_weeks={num_weeks} (max {PACK_MAX_WEEKS}); use "
            f"impl='auto' for the 4-column fallback")
    return impl


def _sort_words(words: torch.Tensor, dest: torch.Tensor,
                num_partitions: int):
    """The "sort" impl: stable argsort by destination (the counting
    sort's oracle)."""
    return count_scatter_ref(words, dest, num_partitions)


def _counting_words(words: torch.Tensor, dest: torch.Tensor,
                    num_partitions: int):
    """The "counting" impl: stable counting sort (kernels K1 and K2 on
    the card)."""
    return count_scatter(words, dest, num_partitions)


def order_words(log: EventLog, num_weeks: int, impl: str,
                group: Optional[nodes.NodeGroup] = None):
    """Mapper side of every node of a ``[P_local, n]`` log: project each
    record to its word (invalid rows -> the zero word, bound for the
    pseudo-destination P) and order the words by destination ``site % P``,
    once. Returns ``(words_sorted [P_local, n], starts [P_local, P+1])``.
    One ``shuffle.order`` span."""
    p = nodes.group_of_rows(group, log.site_id.shape[0]).nodes
    with trace.span("shuffle.order"):
        valid = log.valid_mask()
        dest = torch.where(valid, log.site_id % p,
                           torch.full_like(log.site_id, p)).to(torch.int32)
        words = pack_site_week_mark(log.site_id,
                                    log.week(num_weeks=num_weeks), log.mark,
                                    valid)
        order = _sort_words if impl == "sort" else _counting_words
        return order(words.contiguous(), dest.contiguous(), p)


def _bytes_exchanged(rounds: int, parts: int, capacity: int,
                     max_rounds: int, slot_bytes: int) -> int:
    """Per-node int32 byte count with the JAX package's saturation rule
    (``_shuffle_loop``): exact below the int32 horizon, 2^31 - 1 above."""
    per_round = parts * capacity * slot_bytes
    if per_round * max_rounds > _INT32_MAX:
        warnings.warn(
            f"ShuffleStats.bytes_exchanged may exceed int32 ({per_round} "
            f"B/round x up to {max_rounds} rounds); the value saturates "
            f"instead of wrapping", stacklevel=3)
    per_round_c = min(per_round, _INT32_MAX)
    sat_from = _INT32_MAX // per_round_c + 1
    return _INT32_MAX if rounds >= sat_from else rounds * per_round_c


def ship_round(words_sorted: torch.Tensor, starts: torch.Tensor,
               round_index: int, capacity: int,
               group: Optional[nodes.NodeGroup] = None):
    """One round's exchange: every node fills a ``[P, C]`` bucket per
    destination with window ``[r*C, (r+1)*C)`` of that destination's
    segment (zero words past its end), and each receiver gets bucket d of
    every sender (``ship_buckets``: one K9 launch on the card, the torch
    path on the CPU; a gang's buckets go over gloo). Returns ``(shipped
    [P_local, P*C] words per receiver, sent [P_local] int32: the live
    slots each sender shipped)``."""
    counts = starts[:, 1:] - starts[:, :-1]
    sent = (counts - round_index * capacity).clamp_(0, capacity).sum(
        dim=-1, dtype=torch.int32)
    return ship_buckets(words_sorted, starts, round_index, capacity,
                        group), sent


def exchange_and_reduce(words_sorted: torch.Tensor, starts: torch.Tensor, *,
                        num_sites: int, num_weeks: int, capacity: int,
                        max_rounds: int, word_histogram_fn=None,
                        group: Optional[nodes.NodeGroup] = None):
    """The round loop (JAX ``_word_shuffle_histogram`` body): round r
    ships window ``[r*C, (r+1)*C)`` of every destination segment of every
    node, the receivers reduce the words, and the loop stops when no
    record is left anywhere or ``max_rounds`` ran, each round a
    ``shuffle.round`` span (``req`` r). Returns the owned ``[P_local, S/P,
    W, 2]`` histograms and per-node ``ShuffleStats``."""
    rows = words_sorted.shape[0]
    group = nodes.group_of_rows(group, rows)
    p = group.nodes
    dev = words_sorted.device
    s_local = num_sites // p
    counts = starts[:, 1:] - starts[:, :-1]            # [P_local, P] a dest
    node = group.node_ids(dev)

    def reduce_words(shipped: torch.Tensor) -> torch.Tensor:
        if word_histogram_fn is not None:
            return word_histogram_fn(shipped, s_local, num_weeks, p,
                                     group.first)
        site, week, mark, ok = unpack_site_week_mark(shipped)
        ok = ok & (site % p == node)
        rebased = EventLog(site_id=site // p,
                           entity_id=torch.zeros_like(site),
                           timestamp=week * SECONDS_PER_WEEK, mark=mark,
                           valid=ok)
        return site_week_histogram(rebased, s_local, num_weeks)

    hist = torch.zeros(rows, s_local, num_weeks, 2, dtype=torch.int32,
                       device=dev)
    sent = torch.zeros(rows, dtype=torch.int32, device=dev)
    deferred = torch.zeros(rows, dtype=torch.int32, device=dev)
    global_left = nodes.global_count(starts[:, p], group)   # valid records
    rounds = 0
    while global_left > 0 and rounds < max_rounds:
        with trace.span("shuffle.round", req=rounds):
            shipped, sent_r = ship_round(words_sorted, starts, rounds,
                                         capacity, group)
            left = (counts - (rounds + 1) * capacity).clamp(min=0).sum(
                dim=-1, dtype=torch.int32)
            hist += reduce_words(shipped)
            sent += sent_r
            deferred += left
            global_left = nodes.global_count(left, group)
        rounds += 1

    overflow = (counts - rounds * capacity).clamp(min=0).sum(
        dim=-1, dtype=torch.int32)
    bytes_node = _bytes_exchanged(rounds, p, capacity, max_rounds,
                                  PACKED_SLOT_BYTES)
    stats = ShuffleStats(
        sent=sent, overflow=overflow, capacity=capacity, rounds=rounds,
        residual=deferred,
        bytes_exchanged=torch.full((rows,), bytes_node, dtype=torch.int32,
                                   device=dev))
    return hist, stats


def _pack_buckets(log: EventLog, num_partitions: int, capacity: int):
    """One round's mapper side of the columns exchange (JAX
    ``_pack_buckets``) for every node of a ``[P_local, n]`` log, to the
    ``num_partitions`` destinations.

    The records are ordered stably by destination ``site % P``, invalid
    rows going to the overflow row P (the counting sort K1 + K2 on the
    card, over the row indices). The first ``capacity`` records of each
    destination fill ``[P_local, P, C]`` buckets of the four columns plus
    validity; empty slots hold site -1 and are invalid. The records beyond
    ``capacity`` stay in ``residual``: the ordered columns, same shape,
    whose ``valid`` marks exactly those records. Returns ``(buckets,
    residual, sent [P_local], overflow [P_local])``.
    """
    rows, n = log.site_id.shape
    dev = log.site_id.device
    dest = torch.where(log.valid_mask(), log.site_id % num_partitions,
                       torch.full_like(log.site_id, num_partitions))
    index = torch.arange(n, dtype=torch.int32, device=dev).expand(rows, n)
    order, starts = count_scatter(index.contiguous(),
                                  dest.to(torch.int32).contiguous(),
                                  num_partitions)
    order = order.to(torch.int64)
    cols = [c.gather(1, order) for c in
            (log.site_id, log.entity_id, log.timestamp, log.mark)]
    counts = starts[:, 1:] - starts[:, :-1]             # [P, P] per dest
    lane = torch.arange(capacity, dtype=torch.int32, device=dev)
    live = lane < counts.unsqueeze(-1)                   # [P, P, C]
    slot = (starts[:, :-1].unsqueeze(-1) + lane).clamp_(max=max(n - 1, 0))
    slot = slot.reshape(rows, -1).to(torch.int64)

    def bucket(col, fill):
        taken = col.gather(1, slot).reshape(live.shape)
        return torch.where(live, taken, torch.full((), fill, dtype=col.dtype,
                                                   device=dev))

    site = bucket(cols[0], -1)
    buckets = (site, bucket(cols[1], 0), bucket(cols[2], 0),
               bucket(cols[3], 0), site >= 0)
    dest_sorted = dest.gather(1, order)
    rank = (torch.arange(n, dtype=torch.int32, device=dev)
            - starts.gather(1, dest_sorted.to(torch.int64)))
    leftover = (rank >= capacity) & (dest_sorted < num_partitions)
    residual = EventLog(*cols, valid=leftover)
    sent = counts.clamp(max=capacity).sum(-1, dtype=torch.int32)
    overflow = (counts - capacity).clamp(min=0).sum(-1, dtype=torch.int32)
    return buckets, residual, sent, overflow


def ship_columns_round(pending: EventLog, capacity: int, s_local: int,
                       num_weeks: int, histogram_fn,
                       group: Optional[nodes.NodeGroup] = None):
    """One round of the columns exchange: pack, ``all_to_all`` the five
    bucket columns, and reduce what each node received (rebased to
    ``site // P``, kept where ``site % P`` is the node) with
    ``histogram_fn``. Returns ``(owned increment [P_local, S/P, W, 2],
    residual log, sent [P_local], overflow [P_local])``."""
    rows = pending.site_id.shape[0]
    group = nodes.group_of_rows(group, rows)
    p = group.nodes
    buckets, residual, sent, overflow = _pack_buckets(pending, p, capacity)
    site, entity, ts, mark, vmask = (
        nodes.all_to_all(b, group).reshape(rows, -1) for b in buckets)
    del buckets
    rebased = EventLog(site_id=site // p, entity_id=entity, timestamp=ts,
                       mark=mark,
                       valid=vmask & (site % p == group.node_ids(site.device)))
    del site, entity, ts, mark, vmask
    return (histogram_fn(rebased, s_local, num_weeks), residual, sent,
            overflow)


def columns_shuffle_histogram(log: EventLog, *, num_sites: int,
                              num_weeks: int, capacity: int,
                              max_rounds: int,
                              histogram_fn=site_week_histogram,
                              group: Optional[nodes.NodeGroup] = None):
    """The 4-column exchange (JAX ``_unpacked_shuffle_histogram``): rounds
    of ``ship_columns_round`` over the residual log until no record is
    left anywhere or ``max_rounds`` ran. Returns the owned ``[P_local, S/P,
    W, 2]`` histograms and per-node ``ShuffleStats``."""
    rows = log.site_id.shape[0]
    group = nodes.group_of_rows(group, rows)
    p = group.nodes
    dev = log.site_id.device
    s_local = num_sites // p
    pending = EventLog(site_id=log.site_id, entity_id=log.entity_id,
                       timestamp=log.timestamp, mark=log.mark,
                       valid=log.valid_mask())
    hist = torch.zeros(rows, s_local, num_weeks, 2, dtype=torch.int32,
                       device=dev)
    sent = torch.zeros(rows, dtype=torch.int32, device=dev)
    deferred = torch.zeros(rows, dtype=torch.int32, device=dev)
    global_left = nodes.global_count(pending.valid, group)
    rounds = 0
    while global_left > 0 and rounds < max_rounds:
        inc, pending, sent_r, left = ship_columns_round(
            pending, capacity, s_local, num_weeks, histogram_fn, group)
        hist += inc
        sent += sent_r
        deferred += left
        global_left = nodes.global_count(left, group)
        rounds += 1

    bytes_node = _bytes_exchanged(rounds, p, capacity, max_rounds,
                                  UNPACKED_SLOT_BYTES)
    stats = ShuffleStats(
        sent=sent, overflow=pending.valid.sum(-1, dtype=torch.int32),
        capacity=capacity, rounds=rounds, residual=deferred,
        bytes_exchanged=torch.full((rows,), bytes_node, dtype=torch.int32,
                                   device=dev))
    return hist, stats


def mapreduce_histogram(log: EventLog, num_sites: int,
                        num_weeks: int = WEEKS_PER_YEAR,
                        capacity_factor: float = 2.0,
                        max_rounds: Optional[int] = None,
                        impl: str = "auto",
                        histogram_fn=site_week_histogram,
                        word_histogram_fn=None,
                        group: Optional[nodes.NodeGroup] = None):
    """Multi-round lossless shuffle + reduce over a ``[P_local, n]`` log
    (every node of ``group`` holds ``n`` records).

    Returns ``(owned [P_local, num_sites // P, W, 2], per-node
    ShuffleStats)``; ``num_sites % P == 0`` is required (the runner pads).
    ``max_rounds`` ``None`` uses the provable bound ``ceil(n /
    capacity)``; a smaller cap may stop with ``overflow > 0``, which
    callers must check. ``histogram_fn(log, s_local, num_weeks)`` reduces
    what the columns exchange delivers. ``word_histogram_fn(words
    [P_local, L], s_local, num_weeks, P, first_node)``, when given,
    reduces the shipped words of the word exchanges directly (the fused
    kernel K3).
    """
    rows, n = log.site_id.shape
    group = nodes.group_of_rows(group, rows)
    p = group.nodes
    if num_sites % p:
        raise ValueError(f"num_sites ({num_sites}) must divide by the node "
                         f"count ({p}); pad it")
    capacity = static_capacity(n, p, capacity_factor)
    if max_rounds is None:
        max_rounds = shuffle_round_bound(n, capacity)
    if max_rounds < 1:
        raise ValueError(f"max_rounds must be >= 1, got {max_rounds}")
    impl = resolve_exchange_impl(impl, num_sites, num_weeks)
    if impl == "columns":
        return columns_shuffle_histogram(
            log, num_sites=num_sites, num_weeks=num_weeks, capacity=capacity,
            max_rounds=max_rounds, histogram_fn=histogram_fn, group=group)
    words_sorted, starts = order_words(log, num_weeks, impl, group)
    return exchange_and_reduce(
        words_sorted, starts, num_sites=num_sites, num_weeks=num_weeks,
        capacity=capacity, max_rounds=max_rounds,
        word_histogram_fn=word_histogram_fn, group=group)


def mapreduce_combiner_histogram(log: EventLog, num_sites: int,
                                 num_weeks: int = WEEKS_PER_YEAR,
                                 histogram_fn=site_week_histogram,
                                 group: Optional[nodes.NodeGroup] = None,
                                 carry: Optional[torch.Tensor] = None
                                 ) -> torch.Tensor:
    """MapReduce with a combiner (JAX ``mapreduce_combiner_histogram``):
    each node pre-reduces its records into a local ``[S, W, 2]``
    histogram, so the shuffle moves histogram blocks, not records.

    Returns the owned strided blocks ``[P_local, num_sites // P, W, 2]``
    (row i of node d is site ``i * P + d``), equal to
    ``mapreduce_histogram``'s, added into ``carry`` in place where one is
    given (int32 sums wrap). One process exchanges the blocks with
    ``combine_blocks`` (K8 on the card, the torch path on the CPU); a gang
    with the torch path over its gloo collectives. The exchange is a
    ``combiner.blocks`` span; ``combiner.block_bytes`` counts the bytes of
    the blocks that leave their node.
    """
    rows = log.site_id.shape[0]
    group = nodes.group_of_rows(group, rows)
    p = group.nodes
    if num_sites % p:
        raise ValueError(f"num_sites ({num_sites}) must divide by the node "
                         f"count ({p}); pad it")
    s_local = num_sites // p
    local = histogram_fn(log, num_sites, num_weeks)   # [P_local, S, W, 2]
    if carry is None:
        carry = torch.zeros(rows, s_local, num_weeks, 2, dtype=torch.int32,
                            device=local.device)
    trace.count("combiner.block_bytes",
                rows * (p - 1) * s_local * num_weeks * 2 * 4)
    with trace.span("combiner.blocks"):
        if group.distributed:
            return combine_blocks_plain(local, carry, group)
        return combine_blocks(local.contiguous(), carry)


def shuffle_stats(stats: ShuffleStats,
                  group: Optional[nodes.NodeGroup] = None) -> ShuffleStats:
    """Global accounting: int32 sums over all nodes (``capacity`` and
    ``rounds`` are node-uniform and pass through)."""
    return ShuffleStats(
        sent=nodes.psum(stats.sent, group=group),
        overflow=nodes.psum(stats.overflow, group=group),
        capacity=stats.capacity, rounds=stats.rounds,
        residual=nodes.psum(stats.residual, group=group),
        bytes_exchanged=nodes.psum(stats.bytes_exchanged, group=group))
