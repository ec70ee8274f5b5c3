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
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.common.nodes import resolve_device
from repro_torch.common.types import EventLog
from repro_torch.malgen.powerlaw import sample_sites
from repro_torch.malgen.seeding import (
    EventDraws,
    MalGenConfig,
    SeedInfo,
    draw_events,
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
