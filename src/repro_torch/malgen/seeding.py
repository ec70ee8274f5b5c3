"""Phase 1 of MalGen: head-node seeding (paper §5).

Counterpart of ``repro/malgen/seeding.py``. The head node picks the marked
sites, generates every marked-site event of the year and derives the
entity mark table: a marking visit (probability ``p_mark``) marks the
entity ``mark_delay`` after the visit, and the earliest marking visit wins.

Randomness: each stream the JAX package derives from its key by
``split``/``fold_in`` is drawn here from its own ``torch.Generator``, seeded
on the target device by a fixed function of ``(rng_seed, stream tag,
shard id)`` (``stream_generator``). The same seed therefore gives other
records than the JAX package, and other records on the CPU than on the
card. Every function that draws also takes the draws ready-made, so a test
can hand it the numbers JAX drew and compare the results exactly.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.common.nodes import resolve_device
from repro_torch.common.types import (
    NEVER_MARKED,
    SECONDS_PER_WEEK,
    SECONDS_PER_YEAR,
)
from repro_torch.malgen.powerlaw import (
    masked_site_cdf,
    power_law_weights,
    sample_sites,
)


class MalGenConfig(NamedTuple):
    num_sites: int = 100_000
    num_entities: int = 1_000_000
    marked_site_fraction: float = 0.10
    alpha: float = 1.2
    p_mark: float = 0.70
    mark_delay: int = SECONDS_PER_WEEK
    span_seconds: int = SECONDS_PER_YEAR
    marked_event_fraction: float = 0.10

    @property
    def num_marked_sites(self) -> int:
        return max(1, int(self.num_sites * self.marked_site_fraction))


class SeedInfo(NamedTuple):
    """Everything phase 2 scatters to the nodes. ``rng_seed`` stands for
    the JAX root key: the integer every random stream is derived from."""

    rng_seed: int
    marked_mask: torch.Tensor       # bool [num_sites]
    entity_mark_time: torch.Tensor  # int32 [num_entities]
    site_weights: torch.Tensor      # float32 [num_sites]
    num_marked_events: int
    marked_cdf: torch.Tensor        # float32 [num_sites]
    unmarked_cdf: torch.Tensor      # float32 [num_sites]

    @property
    def seed_bytes(self) -> int:
        """Scatter payload size (the paper's Table 3 memory concern)."""
        return (self.marked_mask.numel() + self.entity_mark_time.numel() * 4
                + self.site_weights.numel() * 4 + self.marked_cdf.numel() * 4
                + self.unmarked_cdf.numel() * 4 + 32)

    def to(self, device) -> "SeedInfo":
        return self._replace(**{
            f: getattr(self, f).to(device)
            for f in ("marked_mask", "entity_mark_time", "site_weights",
                      "marked_cdf", "unmarked_cdf")})


class SiteDraws(NamedTuple):
    """The site-table draws: a permutation of the sites (popularity
    order) and the marked site ids (a choice without replacement)."""

    permutation: torch.Tensor
    marked_ids: torch.Tensor


class EventDraws(NamedTuple):
    """The draws behind a run of events: a float32 uniform per event for
    the site, and the int32 entity and timestamp."""

    u_site: torch.Tensor
    entity: torch.Tensor
    timestamp: torch.Tensor


# Append new tags at the end only: a stream is seeded by its tag's index,
# so an insertion would change the records every existing seed gives.
_STREAM_TAGS = ("site_permutation", "marked_sites", "marked_site",
                "marked_entity", "marked_ts", "marked_bernoulli",
                "unmarked_site", "unmarked_entity", "unmarked_ts",
                # the streaming engine's per-chunk streams (shard = chunk id)
                "chunk_marked_site", "chunk_marked_entity", "chunk_marked_ts",
                "chunk_marked_bernoulli", "chunk_unmarked_site",
                "chunk_unmarked_entity", "chunk_unmarked_ts",
                # the token pipeline's synthetic source (data/pipeline.py)
                "token_synthetic")
_MASK64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def stream_generator(rng_seed: int, tag: str, shard: int,
                     device) -> torch.Generator:
    """The generator of one random stream, seeded on ``device`` by a fixed
    function of ``(rng_seed, tag, shard)``."""
    x = _splitmix64(rng_seed & _MASK64)
    x = _splitmix64(x ^ _STREAM_TAGS.index(tag))
    x = _splitmix64(x ^ shard)
    g = torch.Generator(device=device)
    g.manual_seed(x >> 1)
    return g


def draw_events(rng_seed: int, stream: str, shard: int, num: int,
                cfg: MalGenConfig, device) -> EventDraws:
    """Draw ``num`` events of ``stream`` ("marked" or "unmarked", or
    "chunk_marked" / "chunk_unmarked" with ``shard`` the chunk id)."""
    def gen(field):
        return stream_generator(rng_seed, f"{stream}_{field}", shard, device)

    return EventDraws(
        u_site=torch.rand(num, generator=gen("site"), device=device,
                          dtype=torch.float32),
        entity=torch.randint(0, cfg.num_entities, (num,),
                             generator=gen("entity"), device=device,
                             dtype=torch.int32),
        timestamp=torch.randint(0, cfg.span_seconds, (num,),
                                generator=gen("ts"), device=device,
                                dtype=torch.int32))


def draw_events_into(rng_seed: int, stream: str, shard: int,
                     cfg: MalGenConfig, u: torch.Tensor, entity: torch.Tensor,
                     timestamp: torch.Tensor) -> None:
    """``draw_events`` written into ``u`` (float32), ``entity`` and
    ``timestamp`` (int32), contiguous and of one length on one device: the
    same numbers from the same generators (``torch.rand`` and
    ``torch.randint`` are ``uniform_`` and ``random_`` on a new tensor),
    drawn where they will stay."""
    def gen(field):
        return stream_generator(rng_seed, f"{stream}_{field}", shard,
                                u.device)

    u.uniform_(0, 1, generator=gen("site"))
    entity.random_(0, cfg.num_entities, generator=gen("entity"))
    timestamp.random_(0, cfg.span_seconds, generator=gen("ts"))


def _site_tables(rng_seed: int, cfg: MalGenConfig, device,
                 draws: Optional[SiteDraws] = None):
    """(site_weights, marked_mask, marked_cdf, unmarked_cdf)."""
    if draws is None:
        perm = torch.randperm(
            cfg.num_sites, device=device,
            generator=stream_generator(rng_seed, "site_permutation", 0,
                                       device))
        marked_ids = torch.randperm(
            cfg.num_sites, device=device,
            generator=stream_generator(rng_seed, "marked_sites", 0, device)
        )[:cfg.num_marked_sites]
        draws = SiteDraws(perm, marked_ids)
    weights = power_law_weights(cfg.num_sites, cfg.alpha,
                                permutation=draws.permutation.to(device))
    marked_mask = torch.zeros(cfg.num_sites, dtype=torch.bool, device=device)
    marked_mask[draws.marked_ids.to(device).to(torch.int64)] = True
    return (weights, marked_mask, masked_site_cdf(weights, marked_mask),
            masked_site_cdf(weights, ~marked_mask))


def _events(cdf: torch.Tensor, draws: EventDraws):
    """(site, entity, ts) int32 columns of the drawn events."""
    dev = cdf.device
    return (sample_sites(cdf, draws.u_site), draws.entity.to(dev),
            draws.timestamp.to(dev))


def marked_event_stream(seed: SeedInfo, cfg: MalGenConfig,
                        draws: Optional[EventDraws] = None):
    """The global marked-event stream ``(site, entity, ts)``, regenerated
    from the seed on the device its tables live on (the phase-2 scatter
    trick: the seed crosses the network, not the events)."""
    if draws is None:
        draws = draw_events(seed.rng_seed, "marked", 0,
                            seed.num_marked_events, cfg,
                            seed.marked_cdf.device)
    return _events(seed.marked_cdf, draws)


def _apply_mark_delay(earliest: torch.Tensor,
                      cfg: MalGenConfig) -> torch.Tensor:
    """Earliest marking visit -> mark time, never overflowing int32 for
    entities that were never marked."""
    late = earliest >= NEVER_MARKED - cfg.mark_delay
    return torch.where(late, torch.full_like(earliest, NEVER_MARKED),
                       earliest + cfg.mark_delay).to(torch.int32)


def _derive_mark_table(entity: torch.Tensor, ts: torch.Tensor,
                       marks_entity: torch.Tensor,
                       cfg: MalGenConfig) -> torch.Tensor:
    """int32 ``[num_entities]`` mark times: the earliest marking visit of
    each entity plus the delay, ``NEVER_MARKED`` if none."""
    visit_ts = torch.where(marks_entity, ts, torch.full_like(ts, NEVER_MARKED))
    earliest = torch.full((cfg.num_entities,), NEVER_MARKED,
                          dtype=torch.int32, device=ts.device)
    earliest.scatter_reduce_(0, entity.to(torch.int64), visit_ts, "amin")
    return _apply_mark_delay(earliest, cfg)


def make_seed(rng_seed: int, cfg: MalGenConfig, total_records: int, *,
              device=None, site_draws: Optional[SiteDraws] = None,
              marked_draws: Optional[EventDraws] = None,
              bernoulli: Optional[torch.Tensor] = None) -> SeedInfo:
    """Phase 1 for a global budget of ``total_records`` records; the
    marked stream gets ``round(total * marked_event_fraction)`` events.
    Runs on the card unless ``device="cpu"``."""
    return make_seed_with_marked(
        rng_seed, cfg, total_records, device=device, site_draws=site_draws,
        marked_draws=marked_draws, bernoulli=bernoulli)[0]


def make_seed_with_marked(rng_seed: int, cfg: MalGenConfig,
                          total_records: int, *, device=None,
                          site_draws: Optional[SiteDraws] = None,
                          marked_draws: Optional[EventDraws] = None,
                          bernoulli: Optional[torch.Tensor] = None):
    """``(make_seed(...), marked)``: the seed and the global marked stream
    ``(site, entity, ts)`` its mark table was derived from, which
    ``marked_event_stream`` would regenerate, so a caller that keeps the
    stream (the token pipeline) samples its sites once."""
    device = resolve_device(device)
    weights, marked_mask, marked_cdf, unmarked_cdf = _site_tables(
        rng_seed, cfg, device, site_draws)
    num_marked = max(1, int(round(total_records
                                  * cfg.marked_event_fraction)))
    seed = SeedInfo(rng_seed=rng_seed, marked_mask=marked_mask,
                    entity_mark_time=torch.empty(0, dtype=torch.int32),
                    site_weights=weights, num_marked_events=num_marked,
                    marked_cdf=marked_cdf, unmarked_cdf=unmarked_cdf)
    marked = marked_event_stream(seed, cfg, marked_draws)
    _, entity, ts = marked
    if bernoulli is None:
        g = stream_generator(rng_seed, "marked_bernoulli", 0, device)
        bernoulli = torch.rand(num_marked, generator=g,
                               device=device) < cfg.p_mark
    mark_time = _derive_mark_table(entity, ts, bernoulli.to(device), cfg)
    return seed._replace(entity_mark_time=mark_time), marked


def seed_from_numpy(arrays, cfg: MalGenConfig, rng_seed: int, *,
                    device=None) -> SeedInfo:
    """A seed from tables made elsewhere (the JAX package's ``SeedInfo``
    as numpy): ``marked_mask``, ``entity_mark_time``, ``site_weights``,
    ``marked_cdf``, ``unmarked_cdf`` and ``num_marked_events``. The port's
    counterpart of carrying weights across."""
    device = resolve_device(device)

    def col(name, dtype):
        return torch.tensor(np.asarray(arrays[name]), dtype=dtype,
                            device=device)

    seed = SeedInfo(
        rng_seed=rng_seed,
        marked_mask=col("marked_mask", torch.bool),
        entity_mark_time=col("entity_mark_time", torch.int32),
        site_weights=col("site_weights", torch.float32),
        num_marked_events=int(arrays["num_marked_events"]),
        marked_cdf=col("marked_cdf", torch.float32),
        unmarked_cdf=col("unmarked_cdf", torch.float32))
    if (seed.marked_mask.numel() != cfg.num_sites
            or seed.entity_mark_time.numel() != cfg.num_entities):
        raise ValueError("seed tables do not match the MalGenConfig sizes")
    return seed


# ---------------------------------------------------------------------------
# Streaming (chunk-keyed) seeding: the streaming engine's phase 1.
#
# Every random stream of a chunk has its own generator, seeded by (rng_seed,
# tag, chunk id): the JAX package's ``chunk_keys`` split of ``fold_in(key,
# chunk_id)``. ``make_seed_streaming`` draws each chunk's marked entities,
# timestamps and Bernoulli trials from the same generators that
# ``generate_chunk`` draws the chunk's marked rows from, so the mark table
# corresponds to the marking visits in the records.
# ---------------------------------------------------------------------------

class ChunkMarkDraws(NamedTuple):
    """The draws behind one chunk's marked rows that the mark table needs:
    int32 entity and timestamp, and the bool Bernoulli trial."""

    entity: torch.Tensor
    timestamp: torch.Tensor
    bernoulli: torch.Tensor


def chunk_marked_records(cfg: MalGenConfig, records_per_chunk: int) -> int:
    """Marked-site rows per chunk (every chunk gets the same)."""
    n = int(round(records_per_chunk * cfg.marked_event_fraction))
    return max(0, min(records_per_chunk, n))


def draw_chunk_marks(rng_seed: int, chunk_id: int, num: int,
                     cfg: MalGenConfig, device) -> ChunkMarkDraws:
    """The chunk's ``num`` marked visits (from ``generate_chunk``'s
    generators) and which of them mark the entity."""
    marked = draw_events(rng_seed, "chunk_marked", chunk_id, num, cfg, device)
    g = stream_generator(rng_seed, "chunk_marked_bernoulli", chunk_id, device)
    return ChunkMarkDraws(marked.entity, marked.timestamp,
                          torch.rand(num, generator=g, device=device)
                          < cfg.p_mark)


def make_seed_streaming(rng_seed: int, cfg: MalGenConfig, num_chunks: int,
                        records_per_chunk: int, *, device=None,
                        site_draws: Optional[SiteDraws] = None,
                        chunk_draws: Optional[Sequence[ChunkMarkDraws]]
                        = None) -> SeedInfo:
    """Phase 1 for the streaming engine, in memory bounded by the entity
    table and one chunk: each chunk's marked visits are drawn in turn and
    the earliest marking visit per entity is kept. The seed belongs to the
    log ``generate_chunk`` gives over chunk ids ``[0, num_chunks)`` at
    this ``records_per_chunk``. The site tables are ``make_seed``'s for the
    same ``rng_seed``. ``chunk_draws`` (one per chunk) replace the
    generators' draws. Runs on the card unless ``device="cpu"``."""
    device = resolve_device(device)
    weights, marked_mask, marked_cdf, unmarked_cdf = _site_tables(
        rng_seed, cfg, device, site_draws)
    n_marked = chunk_marked_records(cfg, records_per_chunk)
    if chunk_draws is not None and len(chunk_draws) != num_chunks:
        raise ValueError(f"{len(chunk_draws)} chunk draws for {num_chunks} "
                         f"chunks")
    earliest = torch.full((cfg.num_entities,), NEVER_MARKED,
                          dtype=torch.int32, device=device)
    for chunk_id in range(num_chunks):
        draws = (draw_chunk_marks(rng_seed, chunk_id, n_marked, cfg, device)
                 if chunk_draws is None else chunk_draws[chunk_id])
        ts = draws.timestamp.to(device)
        visit_ts = torch.where(draws.bernoulli.to(device), ts,
                               torch.full_like(ts, NEVER_MARKED))
        earliest.scatter_reduce_(0, draws.entity.to(device).to(torch.int64),
                                 visit_ts, "amin")
    return SeedInfo(rng_seed=rng_seed, marked_mask=marked_mask,
                    entity_mark_time=_apply_mark_delay(earliest, cfg),
                    site_weights=weights,
                    num_marked_events=num_chunks * n_marked,
                    marked_cdf=marked_cdf, unmarked_cdf=unmarked_cdf)
