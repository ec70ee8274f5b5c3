"""Streaming chunked MalStone over P nodes on one device.

Counterpart of ``repro/core/streaming.py``. The statistic is folded chunk
by chunk into a histogram carry, so peak memory is one chunk plus the
carry, whatever the record count. Each step folds one ``[P,
chunk_records]`` chunk (row d is node d's chunk) with the backend's
dataflow:

- ``streams`` / ``sphere``: local combine only (K4 with the kernel
  reducers) into a full-site ``[P, s_pad, W, 2]`` carry; the collective
  (``psum``, resp. ``psum_scatter`` + ``all_gather``) runs once, after the
  last chunk;
- ``mapreduce``: the lossless multi-round record shuffle of the chunk into
  each node's owned strided ``[P, s_pad/P, W, 2]`` block, with per-node
  ``[P]`` ``ShuffleStats`` merged chunk by chunk (``merge_stats``);
- ``mapreduce_combiner``: the combiner's histogram-block exchange of the
  chunk, added into the same owned blocks in place (K8 in one process).

Every function takes a ``group`` (``repro_torch.common.nodes.NodeGroup``;
default: one process with every node). In a gang a process folds the
chunks of its own nodes only, its carry has their ``P_local`` rows, and the
collectives (the mapreduce exchange, the final ``psum``, ``psum_scatter``
and gathers) run over the whole gang, so every process ends with the same
full-site histogram and global ``ShuffleStats``.

The site x week histogram is a commutative monoid, so any chunking gives
the one-shot histogram exactly. The JAX ``lax.scan`` is a Python loop over
chunks here. The carry keeps the JAX package's *global* layout (every leaf
has a leading ``[P]`` axis), which is the port's only layout: the
``state_to_local`` / ``state_to_global`` and ``PartitionSpec`` helpers have
no counterpart.

``fold_chunk`` and ``fold_chunk_range`` update the carry in place (one
fold at full width would otherwise allocate a second 333 MB carry) and
return the advanced state.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from repro_torch.common import nodes as nodes_lib
from repro_torch.common import trace
from repro_torch.common.types import EventLog, ExchangePlan, WEEKS_PER_YEAR
from repro_torch.core.backends import (
    ShuffleStats,
    mapreduce_combiner_histogram,
    mapreduce_histogram,
)
from repro_torch.core.plan import resolve_histogram_fns

STREAM_BACKENDS = ("streams", "sphere", "mapreduce", "mapreduce_combiner")


def _check_backend(backend: str) -> None:
    if backend not in STREAM_BACKENDS:
        raise ValueError(f"unknown streaming backend {backend!r}; have "
                         f"{STREAM_BACKENDS}")


def _zero_stats(parts: int, device) -> ShuffleStats:
    return ShuffleStats(*(torch.zeros(parts, dtype=torch.int32, device=device)
                          for _ in ShuffleStats._fields))


def merge_stats(acc: ShuffleStats, chunk: ShuffleStats) -> ShuffleStats:
    """Fold one chunk's per-node shuffle stats into the carry's, node by
    node: the counters add with int32 wrap (as the JAX package's per-device
    int32 adds do), ``rounds`` keeps the worst chunk, ``capacity`` is the
    chunk's (the same for every chunk). Every field of ``acc`` is an int32
    ``[P]`` tensor; ``chunk`` is ``mapreduce_histogram``'s per-node stats
    (``capacity`` and ``rounds`` ints)."""
    def add(a, b):
        return nodes_lib.psum(torch.stack([a, b]))

    return ShuffleStats(
        sent=add(acc.sent, chunk.sent),
        overflow=add(acc.overflow, chunk.overflow),
        capacity=torch.full_like(acc.capacity, chunk.capacity),
        rounds=torch.clamp(acc.rounds, min=chunk.rounds),
        residual=add(acc.residual, chunk.residual),
        bytes_exchanged=add(acc.bytes_exchanged, chunk.bytes_exchanged))


def carry_init(backend: str, parts: int, s_pad: int, num_weeks: int,
               device, group: Optional[nodes_lib.NodeGroup] = None) -> object:
    """Zero carry on ``device`` for the ``P_local`` nodes of ``group``
    (of ``parts`` = P): ``[P_local, s_pad, W, 2]`` for streams and sphere,
    the owned ``[P_local, s_pad/P, W, 2]`` blocks for the combiner, and for
    mapreduce those blocks plus per-node ``[P_local]`` ShuffleStats (every
    field an int32 tensor)."""
    _check_backend(backend)
    if s_pad % parts:
        raise ValueError(f"s_pad ({s_pad}) must divide by the node count "
                         f"({parts})")
    rows = nodes_lib.group_of(group, parts).local

    def z(*shape):
        return torch.zeros(shape, dtype=torch.int32, device=device)

    if backend in ("streams", "sphere"):
        return z(rows, s_pad, num_weeks, 2)
    owned = z(rows, s_pad // parts, num_weeks, 2)
    if backend == "mapreduce":
        return (owned, _zero_stats(rows, device))
    return owned


def carry_zeros_host(backend: str, parts: int, s_pad: int,
                     num_weeks: int) -> object:
    """``carry_init`` on the CPU (the JAX package's host-side layout)."""
    return carry_init(backend, parts, s_pad, num_weeks, "cpu")


def _accumulate_chunk(carry, chunk: EventLog, backend: str, s_pad: int,
                      num_weeks: int, plan: ExchangePlan,
                      group: Optional[nodes_lib.NodeGroup] = None):
    """Fold one ``[P_local, C]`` chunk into the carry with the backend's
    dataflow (in place): one ``stream.fold`` span."""
    hist_fn, word_fn = resolve_histogram_fns(plan)
    with trace.span("stream.fold"):
        if backend in ("streams", "sphere"):
            carry += hist_fn(chunk, s_pad, num_weeks)
            return carry
        if backend == "mapreduce":
            owned, stats = carry
            inc, chunk_stats = mapreduce_histogram(
                chunk, s_pad, num_weeks,
                capacity_factor=plan.capacity_factor,
                max_rounds=plan.max_shuffle_rounds, impl=plan.impl,
                histogram_fn=hist_fn, word_histogram_fn=word_fn,
                group=group)
            owned += inc
            return (owned, merge_stats(stats, chunk_stats))
        if backend == "mapreduce_combiner":
            return mapreduce_combiner_histogram(chunk, s_pad, num_weeks,
                                                histogram_fn=hist_fn,
                                                group=group, carry=carry)
    raise ValueError(f"unknown streaming backend {backend!r}")


def scan_chunk_range(carry, seed, cfg, first_chunks: Sequence[int],
                     num_chunks: int, chunk_records: int, *, s_pad: int,
                     num_weeks: int = WEEKS_PER_YEAR,
                     backend: str = "streams",
                     plan: Optional[ExchangePlan] = None,
                     group: Optional[nodes_lib.NodeGroup] = None):
    """Regenerate and fold ``num_chunks`` steps: step i generates chunk
    ``first_chunks[r] + i`` (global chunk ids) for every local node r
    (``generate_chunks``) and folds it, a ``stream.step`` span (``req``
    i). Any split of a chunk range into consecutive calls gives the same
    carry."""
    from repro_torch.malgen.generator import generate_chunks

    plan = plan or ExchangePlan()
    for i in range(num_chunks):
        with trace.span("stream.step", req=i):
            chunk = generate_chunks(seed, cfg, [f + i for f in first_chunks],
                                    chunk_records)
            carry = _accumulate_chunk(carry, chunk, backend, s_pad,
                                      num_weeks, plan, group)
    return carry


def post_scan_collective(carry, backend: str, s_pad: int, num_weeks: int,
                         group: Optional[nodes_lib.NodeGroup] = None):
    """The carry -> (the full-site ``[s_pad, W, 2]`` histogram, the global
    ShuffleStats for mapreduce, else ``None``); does not change the
    carry. One ``stream.collective`` span."""
    with trace.span("stream.collective"):
        if backend == "streams":
            return nodes_lib.psum(carry, group=group), None
        if backend == "sphere":
            return nodes_lib.all_gather(
                nodes_lib.psum_scatter(carry, group), group), None
        stats = None
        if backend == "mapreduce":
            carry, per_node = carry
            # capacity and rounds are the same on every node (the round
            # loop's stop test is global)
            stats = ShuffleStats(
                sent=nodes_lib.psum(per_node.sent, group=group),
                overflow=nodes_lib.psum(per_node.overflow, group=group),
                capacity=trace.host_read(per_node.capacity[0], "capacity"),
                rounds=trace.host_read(per_node.rounds[0], "rounds"),
                residual=nodes_lib.psum(per_node.residual, group=group),
                bytes_exchanged=nodes_lib.psum(per_node.bytes_exchanged,
                                               group=group))
        # owned rows are strided (site = row * P + d): gather + unstride
        return nodes_lib.all_gather_unstride(carry, group), stats


# ---------------------------------------------------------------------------
# HistogramState: the carry plus the chunk cursor, the resident state of the
# query service (repro_torch.serve). Any sequence of folds covering the same
# chunks gives the same snapshot.
# ---------------------------------------------------------------------------

class HistogramState(NamedTuple):
    """Resident MalStone accumulator: backend carry + chunk cursor (the
    chunks each node has folded; the nodes advance in lockstep)."""

    carry: object
    chunks_folded: int


def state_init(backend: str, parts: int, s_pad: int, num_weeks: int,
               device, group: Optional[nodes_lib.NodeGroup] = None
               ) -> HistogramState:
    return HistogramState(carry_init(backend, parts, s_pad, num_weeks,
                                     device, group), 0)


def state_zeros_host(backend: str, parts: int, s_pad: int,
                     num_weeks: int) -> HistogramState:
    return state_init(backend, parts, s_pad, num_weeks, "cpu")


def fold_chunk(state: HistogramState, chunk: EventLog, *, backend: str,
               s_pad: int, num_weeks: int = WEEKS_PER_YEAR,
               plan: Optional[ExchangePlan] = None,
               group: Optional[nodes_lib.NodeGroup] = None) -> HistogramState:
    """Fold one materialized ``[P_local, chunk_records]`` chunk (row r is
    local node r's) into the state: the streaming engine's step, so the
    mapreduce shuffle and its stats are exactly the engine's."""
    _check_backend(backend)
    with trace.span("stream.step", req=0):
        carry = _accumulate_chunk(state.carry, chunk, backend, s_pad,
                                  num_weeks, plan or ExchangePlan(), group)
    return HistogramState(carry, state.chunks_folded + 1)


def fold_chunk_range(state: HistogramState, seed, cfg,
                     first_chunks: Sequence[int], num_chunks: int,
                     chunk_records: int, *, s_pad: int,
                     num_weeks: int = WEEKS_PER_YEAR,
                     backend: str = "streams",
                     plan: Optional[ExchangePlan] = None,
                     group: Optional[nodes_lib.NodeGroup] = None
                     ) -> HistogramState:
    """Regenerate and fold ``num_chunks`` steps (``scan_chunk_range``),
    advancing the cursor by ``num_chunks``."""
    _check_backend(backend)
    carry = scan_chunk_range(state.carry, seed, cfg, first_chunks,
                             num_chunks, chunk_records, s_pad=s_pad,
                             num_weeks=num_weeks, backend=backend, plan=plan,
                             group=group)
    return HistogramState(carry, state.chunks_folded + num_chunks)


def snapshot(state: HistogramState, *, backend: str, s_pad: int,
             num_weeks: int = WEEKS_PER_YEAR,
             group: Optional[nodes_lib.NodeGroup] = None):
    """The full-site histogram (and mapreduce's global ShuffleStats) of the
    state, which stays as it is: a resident service keeps folding."""
    return post_scan_collective(state.carry, backend, s_pad, num_weeks,
                                group)


def streaming_histogram_from_log(log: EventLog, s_pad: int,
                                 chunk_records: int,
                                 num_weeks: int = WEEKS_PER_YEAR,
                                 backend: str = "streams",
                                 plan: Optional[ExchangePlan] = None,
                                 group: Optional[nodes_lib.NodeGroup] = None):
    """Chunked histogram over a ``[P_local, n]`` log: node d folds its
    records in steps of ``chunk_records``. ``n`` must divide by
    ``chunk_records`` (the runner pads with invalid rows). Returns
    ``(histogram [s_pad, W, 2], ShuffleStats or None)``."""
    _check_backend(backend)
    rows, n = log.site_id.shape
    parts = nodes_lib.group_of_rows(group, rows).nodes
    if n % chunk_records:
        raise ValueError(
            f"per-node record count ({n}) must be divisible by "
            f"chunk_records ({chunk_records}); pad the log with invalid rows "
            f"first (pad_log_to)")
    plan = plan or ExchangePlan()
    log = log._replace(valid=log.valid_mask())
    carry = carry_init(backend, parts, s_pad, num_weeks, log.site_id.device,
                       group)
    for j in range(n // chunk_records):
        cols = slice(j * chunk_records, (j + 1) * chunk_records)
        chunk = log.map(lambda c: c[:, cols].contiguous())
        carry = _accumulate_chunk(carry, chunk, backend, s_pad, num_weeks,
                                  plan, group)
    return post_scan_collective(carry, backend, s_pad, num_weeks, group)


def streaming_histogram_generate(seed, cfg, s_pad: int, *, parts: int,
                                 chunks_per_node: int, chunk_records: int,
                                 num_weeks: int = WEEKS_PER_YEAR,
                                 backend: str = "streams",
                                 plan: Optional[ExchangePlan] = None,
                                 group: Optional[nodes_lib.NodeGroup] = None):
    """Generate-as-you-go chunked histogram on the device of the seed's
    tables: node d (of ``parts``; only the nodes of ``group`` here) folds
    chunks ``[d * chunks_per_node, (d+1) * chunks_per_node)``, the layout
    ``generate_chunked_log`` materializes, so the result equals the
    one-shot run over that log. Returns ``(histogram, ShuffleStats or
    None)``."""
    group = nodes_lib.group_of(group, parts)
    with trace.span("run.setup"):
        carry = carry_init(backend, parts, s_pad, num_weeks,
                           seed.entity_mark_time.device, group)
    carry = scan_chunk_range(
        carry, seed, cfg,
        [d * chunks_per_node
         for d in range(group.first, group.first + group.local)],
        chunks_per_node, chunk_records, s_pad=s_pad, num_weeks=num_weeks,
        backend=backend, plan=plan, group=group)
    return post_scan_collective(carry, backend, s_pad, num_weeks, group)
