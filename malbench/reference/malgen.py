"""A frozen plain copy of MalGen's seed-mode streams, as the benchmark's
configurations define the log.

Every random stream is a ``torch.Generator`` on the device, seeded by a
fixed function of ``(seed, stream tag, chunk id)``; a chunk's first
``marked_event_fraction`` of rows are visits to marked sites, the rest to
unmarked ones. The site tables are a power law over a random permutation
of the sites, a random tenth of them marked, and their cumulative tables
are scanned on the CPU (in index order, so they are a pure function of the
seed). An entity's mark time is its earliest marking visit (probability
``p_mark``) over every chunk of the log, plus ``mark_delay``.

The site tables are MalGen's own draw from the seed: a random permutation
of the sites (``site_permutation``) and a random tenth of them marked (the
first ``num_sites * marked_site_fraction`` of a second permutation,
``marked_sites``), each from its stream's generator on the device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

NEVER_MARKED = 2**31 - 1
SECONDS_PER_WEEK = 604_800
_MASK64 = (1 << 64) - 1
# a stream's generator is seeded by its tag's place in this list
_TAGS = ("site_permutation", "marked_sites", "marked_site", "marked_entity",
         "marked_ts", "marked_bernoulli", "unmarked_site", "unmarked_entity",
         "unmarked_ts", "chunk_marked_site", "chunk_marked_entity",
         "chunk_marked_ts", "chunk_marked_bernoulli", "chunk_unmarked_site",
         "chunk_unmarked_entity", "chunk_unmarked_ts")


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def generator(seed: int, tag: str, chunk: int, device) -> torch.Generator:
    x = _splitmix64(seed & _MASK64)
    x = _splitmix64(x ^ _TAGS.index(tag))
    x = _splitmix64(x ^ chunk)
    g = torch.Generator(device=device)
    g.manual_seed(x >> 1)
    return g


class Tables(NamedTuple):
    marked_cdf: torch.Tensor       # f32 [S]
    unmarked_cdf: torch.Tensor     # f32 [S]
    mark_time: torch.Tensor        # i32 [entities]


def marked_rows(cfg: dict, chunk_records: int) -> int:
    n = int(round(chunk_records * cfg["marked_event_fraction"]))
    return max(0, min(chunk_records, n))


def _cdf(weights: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    w = torch.where(mask, weights, torch.zeros_like(weights)).cpu()
    c = torch.cumsum(w, dim=0)
    return (c / torch.clamp(c[-1], min=1e-30)).to(weights.device)


def _draws(seed, stream, chunk, num, cfg, device):
    def g(field):
        return generator(seed, f"{stream}_{field}", chunk, device)

    u = torch.rand(num, generator=g("site"), device=device,
                   dtype=torch.float32)
    entity = torch.randint(0, cfg["num_entities"], (num,),
                           generator=g("entity"), device=device,
                           dtype=torch.int32)
    ts = torch.randint(0, cfg["span_seconds"], (num,), generator=g("ts"),
                       device=device, dtype=torch.int32)
    return u, entity, ts


def site_draws(seed: int, cfg: dict, device):
    """(permutation, marked ids) on ``device``: site s has popularity rank
    ``permutation[s]`` (0 the most popular); the marked sites are a random
    ``marked_site_fraction`` of the sites."""
    s = cfg["num_sites"]
    perm = torch.randperm(s, device=device, generator=generator(
        seed, "site_permutation", 0, device))
    num_marked = max(1, int(s * cfg["marked_site_fraction"]))
    marked = torch.randperm(s, device=device, generator=generator(
        seed, "marked_sites", 0, device))[:num_marked]
    return perm, marked


def tables(seed: int, cfg: dict, num_chunks: int, chunk_records: int,
           device) -> Tables:
    """The site tables and the entity mark table of the log of
    ``num_chunks`` chunks."""
    s = cfg["num_sites"]
    perm, marked_ids = site_draws(seed, cfg, device)
    ranks = torch.arange(1, s + 1, dtype=torch.float32, device=device)
    w = ranks ** (-cfg["alpha"])
    w = (w / w.sum())[perm]
    marked = torch.zeros(s, dtype=torch.bool, device=device)
    marked[marked_ids.to(torch.int64)] = True
    n_m = marked_rows(cfg, chunk_records)
    earliest = torch.full((cfg["num_entities"],), NEVER_MARKED,
                          dtype=torch.int32, device=device)
    for chunk in range(num_chunks):
        _, entity, ts = _draws(seed, "chunk_marked", chunk, n_m, cfg, device)
        hit = torch.rand(n_m, device=device, generator=generator(
            seed, "chunk_marked_bernoulli", chunk, device)) < cfg["p_mark"]
        visit = torch.where(hit, ts, torch.full_like(ts, NEVER_MARKED))
        earliest.scatter_reduce_(0, entity.to(torch.int64), visit, "amin")
    delay = cfg["mark_delay"]
    late = earliest >= NEVER_MARKED - delay
    mark_time = torch.where(late, torch.full_like(earliest, NEVER_MARKED),
                            earliest + delay).to(torch.int32)
    return Tables(_cdf(w, marked), _cdf(w, ~marked), mark_time)


def chunk_records_of(seed: int, cfg: dict, tabs: Tables, chunk: int,
                     chunk_records: int):
    """(site, week, mark) int64 columns of one chunk, the marked rows
    first."""
    n_m = marked_rows(cfg, chunk_records)
    device = tabs.mark_time.device
    cols = []
    for stream, n, cdf in (("chunk_marked", n_m, tabs.marked_cdf),
                           ("chunk_unmarked", chunk_records - n_m,
                            tabs.unmarked_cdf)):
        u, entity, ts = _draws(seed, stream, chunk, n, cfg, device)
        site = torch.searchsorted(cdf, u, right=True).clamp_(
            max=cfg["num_sites"] - 1)
        mark = tabs.mark_time[entity.to(torch.int64)] <= ts
        week = torch.div(ts, SECONDS_PER_WEEK, rounding_mode="floor").clamp_(
            0, cfg["num_weeks"] - 1)
        cols.append((site, week.to(torch.int64), mark.to(torch.int64)))
    return tuple(torch.cat(c) for c in zip(*cols))
