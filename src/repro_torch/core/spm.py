"""The SPM statistic (paper Sections 3-4) on torch tensors.

Counterpart of ``repro/core/spm.py``: ``site_week_histogram`` is the plain
``index_add_`` reduction of ``segment_hist_ref`` (the JAX version is
``segment_sum``, not a Pallas kernel), and the finalizers turn the
``[S, W, 2]`` histogram into MalStone A, B and B with a fixed
denominator. Integer sums stay in int32, as in the JAX package. On the
card MalStone B runs K7.
"""

from __future__ import annotations

import torch

from repro_torch.common.types import (
    EventLog,
    SpmResult,
    WEEKS_PER_YEAR,
    safe_ratio,
)
from repro_torch.kernels.segment_hist.ref import segment_hist_ref
from repro_torch.kernels.windowed_ratio.ops import windowed_ratio


def site_week_histogram(log: EventLog, num_sites: int,
                        num_weeks: int = WEEKS_PER_YEAR,
                        site_offset: int = 0) -> torch.Tensor:
    """Dense (total, marked) counts per (site, week): int32
    ``[*batch, num_sites, num_weeks, 2]`` for a log of shape
    ``[*batch, n]`` (one histogram per node of a ``[P, n]`` log).

    Rows that are invalid or whose rebased site is out of range count
    nowhere.
    """
    batch = log.site_id.shape[:-1]
    n = log.site_id.shape[-1]

    def rows(x):
        return x.reshape(-1, n)

    hist = segment_hist_ref(rows(log.site_id - site_offset),
                            rows(log.week(num_weeks=num_weeks)),
                            rows(log.mark), rows(log.valid_mask()),
                            num_sites, num_weeks)
    return hist.reshape(*batch, num_sites, num_weeks, 2)


def malstone_a(hist: torch.Tensor) -> SpmResult:
    """MalStone A: one ratio per site over the whole year."""
    total = hist[..., 0].sum(dim=-1, dtype=torch.int32)
    marked = hist[..., 1].sum(dim=-1, dtype=torch.int32)
    return SpmResult(rho=safe_ratio(marked, total), total=total, marked=marked)


def malstone_b(hist: torch.Tensor) -> SpmResult:
    """MalStone B: running weekly ratio cum_marked / cum_total.

    A CUDA histogram ``[..., W, 2]`` goes through K7 (``windowed_ratio``)
    as ``[-1, W, 2]``, which computes the same function; on the CPU it is
    the two int32 cumsums and ``safe_ratio`` below."""
    if hist.device.type == "cuda":
        rho, cum_total, cum_marked = windowed_ratio(
            hist.reshape(-1, *hist.shape[-2:]).contiguous())
        shape = hist.shape[:-1]
        return SpmResult(rho=rho.reshape(shape), total=cum_total.reshape(
            shape), marked=cum_marked.reshape(shape))
    cum_total = torch.cumsum(hist[..., 0], dim=-1, dtype=torch.int32)
    cum_marked = torch.cumsum(hist[..., 1], dim=-1, dtype=torch.int32)
    return SpmResult(rho=safe_ratio(cum_marked, cum_total),
                     total=cum_total, marked=cum_marked)


def malstone_b_fixed_denominator(hist: torch.Tensor) -> SpmResult:
    """Definition 1 literal reading: the denominator is the year total."""
    cum_marked = torch.cumsum(hist[..., 1], dim=-1, dtype=torch.int32)
    total_year = hist[..., 0].sum(dim=-1, keepdim=True, dtype=torch.int32)
    den = total_year.expand(cum_marked.shape).contiguous()
    return SpmResult(rho=safe_ratio(cum_marked, den),
                     total=den, marked=cum_marked)


def malstone_a_from_log(log: EventLog, num_sites: int,
                        num_weeks: int = WEEKS_PER_YEAR) -> SpmResult:
    return malstone_a(site_week_histogram(log, num_sites, num_weeks))


def malstone_b_from_log(log: EventLog, num_sites: int,
                        num_weeks: int = WEEKS_PER_YEAR) -> SpmResult:
    return malstone_b(site_week_histogram(log, num_sites, num_weeks))


# ----------------------------------------------------------------------------
# Set-semantics oracle (Definition 1 over entity sets). O(records * entities)
# memory and time: for tests and small data only.
# ----------------------------------------------------------------------------

def spm_entity_sets(site_id, entity_id, timestamp,
                    entity_mark_time, num_sites: int,
                    exp_start: int, exp_end: int,
                    mon_start: int, mon_end: int,
                    num_entities: int) -> torch.Tensor:
    """rho_j per Definition 1 with true entity sets.

    ``entity_mark_time[e]`` is the time entity e became marked
    (``NEVER_MARKED`` if never). A_j holds the entities that visit j within
    ``[exp_start, exp_end)`` strictly before their mark time; B_j the
    members of A_j whose mark time falls in ``[mon_start, mon_end)``.
    """
    visit_in_exp = (timestamp >= exp_start) & (timestamp < exp_end)
    mark_t = entity_mark_time[entity_id.to(torch.int64)]
    qualifies = visit_in_exp & (timestamp < mark_t)

    # membership matrix: a max over the records of each (site, entity) pair
    pair = site_id.to(torch.int64) * num_entities + entity_id
    in_a = torch.full((num_sites * num_entities,),
                      torch.iinfo(torch.int32).min, dtype=torch.int32,
                      device=site_id.device)
    in_a.scatter_reduce_(0, pair, qualifies.to(torch.int32), "amax")
    # an empty pair keeps the dtype's minimum, as JAX's segment_max fills it
    in_a = torch.clamp(in_a, min=0).reshape(num_sites, num_entities)

    marked_in_mon = ((entity_mark_time >= mon_start)
                     & (entity_mark_time < mon_end))
    a_size = in_a.sum(dim=1, dtype=torch.int32)
    b_size = (in_a * marked_in_mon[None, :].to(torch.int32)).sum(
        dim=1, dtype=torch.int32)
    return safe_ratio(b_size, a_size)
