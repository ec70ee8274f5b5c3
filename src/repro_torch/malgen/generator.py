"""Phases 2-3 of MalGen: every node generates its own shard (paper §5).

Counterpart of ``repro/malgen/generator.py``. Shard s holds its strided
slice ``s, s+P, s+2P, ...`` of the global marked-event stream, followed by
its own unmarked-site traffic; every record carries the joined mark flag
of paper §4 (1 iff the entity's mark time is <= the visit time).

``generate_shards_device`` generates all P shards as ``[P, rps]`` columns
on the device. It regenerates the global marked stream once and gives each
shard its slice (the JAX code regenerates it on every device; the records
are the same), and it draws each shard's exact unmarked count from that
shard's own generators, so the JAX package's two-candidate draw, which
exists only because threefry's output depends on the shape of the draw,
is not needed.

``generate_chunk`` is the streaming engine's chunk-keyed generator: every
chunk has the same layout (its first ``chunk_marked_records`` rows are
marked-site traffic) and all its randomness comes from generators seeded
by its chunk id, so the log is a pure function of (seed, chunk id).
``generate_chunks`` makes the P chunks that one streaming step folds as
``[P, chunk_records]`` columns, each written once in place (K6 fused with
the mark join on the card); ``generate_chunk`` and
``generate_chunked_log`` stay the plain composition it is held to.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.common import trace
from repro_torch.common.nodes import resolve_device
from repro_torch.common.types import EventLog
from repro_torch.kernels.powerlaw_sample.ops import powerlaw_sample_join
from repro_torch.malgen.powerlaw import sample_sites
from repro_torch.malgen.seeding import (
    EventDraws,
    MalGenConfig,
    SeedInfo,
    chunk_marked_records,
    draw_events,
    draw_events_into,
    marked_event_stream,
)


def _fnv1a32(text: str) -> int:
    """FNV-1a: the "hash of the hostname" in the paper's Event ID."""
    h = 0x811C9DC5
    for b in text.encode():
        h ^= b
        h = (h * 0x01000193) & 0xFFFFFFFF
    return h


def _as_int32_bits(value: int) -> int:
    return value - (1 << 32) if value >= 1 << 31 else value


def shard_marked_budget(num_marked: int, num_shards: int,
                        records_per_shard: int) -> tuple[int, int]:
    """(q, r) of the per-shard marked-row layout: shard s owns
    ``q + (s < r)`` marked rows. Raises if a shard's slice would exceed
    its record budget (that would lose records)."""
    q, r = divmod(num_marked, num_shards)
    worst = q + (1 if r else 0)
    if worst > records_per_shard:
        raise ValueError(
            f"shard layout ({num_shards} x {records_per_shard}) cannot hold "
            f"the marked stream: shard 0 owns {worst} of {num_marked} "
            f"marked events > records_per_shard={records_per_shard}; "
            f"regenerate the seed with total_records = num_shards * "
            f"records_per_shard")
    return q, r


def generate_shard(seed: SeedInfo, cfg: MalGenConfig, shard_id: int,
                   num_shards: int, records_per_shard: int, *,
                   marked=None,
                   unmarked: Optional[EventDraws] = None) -> EventLog:
    """Phase 3 on one shard, on the device of the seed's tables.

    ``marked`` is the global marked stream ``(site, entity, ts)`` (default:
    regenerated from the seed); ``unmarked`` the shard's unmarked draws
    (default: drawn from the shard's own generators).
    """
    n_marked_global = seed.num_marked_events
    n_marked_local = len(range(shard_id, n_marked_global, num_shards))
    if n_marked_local > records_per_shard:
        raise ValueError(
            f"shard {shard_id}: {n_marked_local} marked events exceed "
            f"records_per_shard={records_per_shard} (global marked stream "
            f"{n_marked_global} over {num_shards} shards); regenerate the "
            f"seed with total_records = num_shards * records_per_shard")
    n_unmarked = records_per_shard - n_marked_local
    device = seed.entity_mark_time.device
    if marked is None:
        marked = marked_event_stream(seed, cfg)
    m_site, m_entity, m_ts = (x.to(device)[shard_id::num_shards]
                              for x in marked)
    if unmarked is None:
        unmarked = draw_events(seed.rng_seed, "unmarked", shard_id,
                               n_unmarked, cfg, device)
    if unmarked.u_site.numel() != n_unmarked:
        raise ValueError(f"shard {shard_id}: {unmarked.u_site.numel()} "
                         f"unmarked draws for {n_unmarked} unmarked rows")
    u_site = sample_sites(seed.unmarked_cdf, unmarked.u_site)

    site = torch.cat([m_site, u_site])
    entity = torch.cat([m_entity, unmarked.entity.to(device)])
    ts = torch.cat([m_ts, unmarked.timestamp.to(device)])
    mark = (seed.entity_mark_time[entity.to(torch.int64)] <= ts).to(
        torch.int32)
    shard_hash = torch.full((records_per_shard,),
                            _as_int32_bits(_fnv1a32(f"node{shard_id:04d}")),
                            dtype=torch.int32, device=device)
    event_seq = torch.arange(records_per_shard, dtype=torch.int32,
                             device=device)
    return EventLog(site_id=site, entity_id=entity, timestamp=ts, mark=mark,
                    event_seq=event_seq, shard_hash=shard_hash)


def generate_shards_device(seed: SeedInfo, cfg: MalGenConfig,
                           num_shards: int, records_per_shard: int, *,
                           device=None,
                           marked_draws: Optional[EventDraws] = None,
                           unmarked_draws: Optional[Sequence[EventDraws]]
                           = None) -> EventLog:
    """All ``num_shards`` shards as ``[P, records_per_shard]`` columns on
    ``device`` (the card unless ``device="cpu"``); row s equals
    ``generate_shard(seed, cfg, s, P, rps)``. ``marked_draws`` and
    ``unmarked_draws`` (one per shard) replace the generators' draws."""
    device = resolve_device(device)
    shard_marked_budget(seed.num_marked_events, num_shards,
                        records_per_shard)
    marked = tuple(x.to(device)
                   for x in marked_event_stream(seed, cfg, marked_draws))
    seed = seed.to(device)
    shards = [
        generate_shard(seed, cfg, s, num_shards, records_per_shard,
                       marked=marked,
                       unmarked=None if unmarked_draws is None
                       else unmarked_draws[s])
        for s in range(num_shards)]
    return EventLog(*[None if cols[0] is None else torch.stack(cols)
                      for cols in zip(*shards)])


# ---------------------------------------------------------------------------
# Chunk-keyed generation: the streaming engine's phase 3.
# ---------------------------------------------------------------------------

_MASK32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2^32`` for ``x`` in ``[0, 2^32)`` (int64), in two 16-bit
    halves of ``c`` so no product leaves int64: torch has no uint32
    multiply."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def _mix32(x) -> torch.Tensor:
    """Murmur3's finalizer on uint32 values held in int64 (the JAX
    ``_mix32``), returned in ``[0, 2^32)``."""
    x = torch.as_tensor(x, dtype=torch.int64) & _MASK32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def chunk_shard_hash(chunk_id) -> torch.Tensor:
    """The Event-ID namespace of a chunk, as the int32 bit pattern of the
    JAX package's uint32 ``chunk_shard_hash``: ``_mix32(chunk_id + 1)``
    (salted so chunk 0 does not hash to padding's 0). ``chunk_id`` is an
    int or an integer tensor."""
    x = _mix32(torch.as_tensor(chunk_id, dtype=torch.int64) + 1)
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def generate_chunk(seed: SeedInfo, cfg: MalGenConfig, chunk_id: int,
                   records_per_chunk: int, *,
                   marked: Optional[EventDraws] = None,
                   unmarked: Optional[EventDraws] = None) -> EventLog:
    """One chunk of ``records_per_chunk`` records on the device of the
    seed's tables. ``seed`` comes from ``make_seed_streaming`` at the same
    ``records_per_chunk``. ``marked`` and ``unmarked`` replace the chunk's
    generators' draws. Three spans: ``malgen.draw`` (the uniform draws),
    ``malgen.sample`` (the sites, K6 on the card) and ``malgen.assemble``
    (the columns joined, the mark looked up)."""
    c = records_per_chunk
    n_marked = chunk_marked_records(cfg, c)
    device = seed.entity_mark_time.device
    with trace.span("malgen.draw"):
        if marked is None:
            marked = draw_events(seed.rng_seed, "chunk_marked", chunk_id,
                                 n_marked, cfg, device)
        if unmarked is None:
            unmarked = draw_events(seed.rng_seed, "chunk_unmarked", chunk_id,
                                   c - n_marked, cfg, device)
    if (marked.u_site.numel() != n_marked
            or unmarked.u_site.numel() != c - n_marked):
        raise ValueError(f"chunk {chunk_id}: draws of {marked.u_site.numel()}"
                         f" + {unmarked.u_site.numel()} rows for {n_marked} "
                         f"marked + {c - n_marked} unmarked")
    with trace.span("malgen.sample"):
        sites = [sample_sites(seed.marked_cdf, marked.u_site),
                 sample_sites(seed.unmarked_cdf, unmarked.u_site)]
    with trace.span("malgen.assemble"):
        site = torch.cat(sites)
        entity = torch.cat([marked.entity.to(device),
                            unmarked.entity.to(device)])
        ts = torch.cat([marked.timestamp.to(device),
                        unmarked.timestamp.to(device)])
        mark = (seed.entity_mark_time[entity.to(torch.int64)] <= ts).to(
            torch.int32)
        shard_hash = torch.full((c,), int(chunk_shard_hash(chunk_id)),
                                dtype=torch.int32, device=device)
        event_seq = torch.arange(c, dtype=torch.int32, device=device)
    return EventLog(site_id=site, entity_id=entity, timestamp=ts, mark=mark,
                    event_seq=event_seq, shard_hash=shard_hash)


def _stack_logs(logs: Sequence[EventLog], stack) -> EventLog:
    return EventLog(*[None if cols[0] is None else stack(cols)
                      for cols in zip(*logs)])


def generate_chunks(seed: SeedInfo, cfg: MalGenConfig,
                    chunk_ids: Sequence[int],
                    records_per_chunk: int) -> EventLog:
    """The chunks ``chunk_ids`` as ``[len(chunk_ids), records_per_chunk]``
    columns: row d is node d's chunk of one streaming step, equal to
    ``generate_chunk(seed, cfg, chunk_ids[d], records_per_chunk)``.

    Every column is written once, where it stays: the step's six int32
    columns and one chunk's site draws are allocated (``malgen.assemble``,
    no device work); a row's entity and timestamp draws go straight into
    their slices of the row and its uniform draws into the buffer, from
    ``generate_chunk``'s generators (``malgen.draw``); then one
    ``powerlaw_sample_join`` a half of the row (marked rows, then
    unmarked) writes the sites, the marks, the event ids and the hash
    (``malgen.sample``; K6 and the join on the card). One
    ``malgen.generate`` span; counts ``malgen.chunks_in_place``."""
    c = records_per_chunk
    n_marked = chunk_marked_records(cfg, c)
    if seed.entity_mark_time.numel() < cfg.num_entities:
        raise ValueError(f"the seed's mark table has "
                         f"{seed.entity_mark_time.numel()} entities, the "
                         f"config draws {cfg.num_entities}")
    device = seed.entity_mark_time.device
    halves = [h for h in ((0, n_marked, "chunk_marked", seed.marked_cdf),
                          (n_marked, c, "chunk_unmarked", seed.unmarked_cdf))
              if h[1] > h[0]]
    hashes = chunk_shard_hash(torch.tensor(list(chunk_ids),
                                           dtype=torch.int64)).tolist()
    with trace.span("malgen.generate"):
        with trace.span("malgen.assemble"):
            site, entity, ts, mark, event_seq, shard_hash = (
                torch.empty((len(chunk_ids), c), dtype=torch.int32,
                            device=device) for _ in range(6))
            u = torch.empty(c, dtype=torch.float32, device=device)
        for d, chunk_id in enumerate(chunk_ids):
            with trace.span("malgen.draw"):
                for lo, hi, stream, _ in halves:
                    draw_events_into(seed.rng_seed, stream, chunk_id, cfg,
                                     u[lo:hi], entity[d, lo:hi],
                                     ts[d, lo:hi])
            with trace.span("malgen.sample"):
                for lo, hi, _, cdf in halves:
                    powerlaw_sample_join(
                        u[lo:hi], cdf, entity[d, lo:hi], ts[d, lo:hi],
                        seed.entity_mark_time, site[d, lo:hi],
                        mark[d, lo:hi], event_seq[d, lo:hi],
                        shard_hash[d, lo:hi], seq_start=lo,
                        hash_value=hashes[d])
        trace.count("malgen.chunks_in_place", len(chunk_ids))
    return EventLog(site_id=site, entity_id=entity, timestamp=ts, mark=mark,
                    event_seq=event_seq, shard_hash=shard_hash)


def generate_chunked_log(seed: SeedInfo, cfg: MalGenConfig, num_chunks: int,
                         records_per_chunk: int) -> EventLog:
    """The chunk-keyed log, chunks concatenated in chunk order (flat): the
    one-shot oracle of the seed-mode streaming engine."""
    return _stack_logs([generate_chunk(seed, cfg, c, records_per_chunk)
                        for c in range(num_chunks)], torch.cat)
