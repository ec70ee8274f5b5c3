"""Batched MalStone queries over a resident site x week histogram.

Counterpart of ``repro/serve/queries.py``. A query asks for one statistic
(A, B or B-fixed) over a week-aligned monitor window, optionally with the
top-k sites by rho and a per-site drill-down. N queries are stacked: each
spec becomes one numerator and one denominator week-mask row (``[N, W]``),
and ``batched_query`` answers the whole batch with one launch of the
masked window-ratio kernel (K5 on the card), a stable sort of rho for the
top-k and one gather for the drill-downs. Mask semantics per statistic
(``hist[..., 0]`` total events, ``hist[..., 1]`` marked):

- **A**: both masks are ``week_mask_for_window(mon)``;
- **B**: both masks are the prefix ``[year start, mon_end)``, so the
  growing windows give ``malstone_b``'s rho columns exactly;
- **B-fixed**: the prefix numerator over the exposure-window denominator.

Masks are 0/1, so every count is an exact integer sum.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.common.types import (
    SECONDS_PER_WEEK,
    SECONDS_PER_YEAR,
    WEEKS_PER_YEAR,
    WindowSpec,
)
from repro_torch.core.windows import (
    growing_monitor_windows,
    week_mask_for_window,
)
from repro_torch.kernels.windowed_ratio import masked_window_ratio

STATISTICS = ("A", "B", "B-fixed")


@dataclasses.dataclass(frozen=True)
class QuerySpec:
    """One query against the resident histogram.

    ``window.mon_*`` bounds the monitor window (week-aligned seconds);
    ``window.exp_*`` matters only for ``B-fixed``. ``top_k > 0`` also
    returns the k sites of highest rho; ``site`` also returns that site's
    rho and raw week rows.
    """

    statistic: str = "B"
    window: WindowSpec = WindowSpec.full_year()
    top_k: int = 0
    site: Optional[int] = None

    def __post_init__(self):
        if self.statistic not in STATISTICS:
            raise ValueError(
                f"unknown statistic {self.statistic!r}; have {STATISTICS}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if self.site is not None and self.site < 0:
            raise ValueError(f"site must be >= 0, got {self.site}")


@dataclasses.dataclass(frozen=True)
class QueryBatch:
    """N stacked query specs encoded as host-side mask arrays."""

    specs: tuple                # the QuerySpecs, in order
    num_masks: np.ndarray       # bool [N, W] numerator week mask per query
    den_masks: np.ndarray       # bool [N, W] denominator week mask
    sites: np.ndarray           # int32 [N] drill-down site (0 when unused)
    max_top_k: int              # k of the shared top-k (0 = none)


@dataclasses.dataclass(frozen=True)
class QueryAnswer:
    """The answer to one QuerySpec (numpy, on the host)."""

    spec: QuerySpec
    rho: np.ndarray                           # f32 [num_sites]
    num: np.ndarray                           # i32 [num_sites]
    den: np.ndarray                           # i32 [num_sites]
    top_sites: Optional[np.ndarray] = None    # i32 [top_k]
    top_rho: Optional[np.ndarray] = None      # f32 [top_k]
    site_rho: Optional[float] = None          # drill-down ratio
    site_total: Optional[np.ndarray] = None   # i32 [W] raw week row
    site_marked: Optional[np.ndarray] = None  # i32 [W]


def query_masks(spec: QuerySpec, num_weeks: int = WEEKS_PER_YEAR):
    """(numerator, denominator) bool ``[W]`` week masks of one spec."""
    win = spec.window
    mon = week_mask_for_window(win, num_weeks)
    prefix = week_mask_for_window(
        WindowSpec(win.exp_start, win.exp_end, 0, win.mon_end), num_weeks)
    if spec.statistic == "A":
        return mon, mon
    if spec.statistic == "B":
        return prefix, prefix
    exposure = week_mask_for_window(
        WindowSpec(win.exp_start, win.exp_end, win.exp_start, win.exp_end),
        num_weeks)
    return prefix, exposure


def encode_query_batch(specs: Sequence[QuerySpec],
                       num_weeks: int = WEEKS_PER_YEAR,
                       num_sites: Optional[int] = None) -> QueryBatch:
    """Stack N specs into one mask batch (on the host)."""
    specs = tuple(specs)
    if not specs:
        raise ValueError("encode_query_batch needs at least one QuerySpec")
    num_masks = np.zeros((len(specs), num_weeks), bool)
    den_masks = np.zeros((len(specs), num_weeks), bool)
    sites = np.zeros((len(specs),), np.int32)
    for i, spec in enumerate(specs):
        nm, dm = query_masks(spec, num_weeks)
        num_masks[i] = nm.numpy()
        den_masks[i] = dm.numpy()
        if spec.site is not None:
            if num_sites is not None and spec.site >= num_sites:
                raise ValueError(
                    f"spec[{i}].site={spec.site} out of range "
                    f"(num_sites={num_sites})")
            sites[i] = spec.site
    max_top_k = max(s.top_k for s in specs)
    if num_sites is not None and max_top_k > num_sites:
        raise ValueError(f"top_k={max_top_k} exceeds num_sites={num_sites}")
    return QueryBatch(specs=specs, num_masks=num_masks, den_masks=den_masks,
                      sites=sites, max_top_k=max_top_k)


def batched_query(hist: torch.Tensor, num_masks: torch.Tensor,
                  den_masks: torch.Tensor, sites: torch.Tensor, *,
                  max_top_k: int = 0):
    """Every answer block of a stacked batch, on the device of ``hist``.

    hist int32 ``[S, W, 2]`` (the resident snapshot), masks bool ``[N,
    W]``, sites int ``[N]``. Returns ``(rho [N, S], num [N, S], den [N,
    S], top_rho [N, k], top_sites [N, k], site_rows [N, W, 2])``. The top-k
    is a stable descending sort of rho, cut to k: equal ratios rank the
    lower site first, as ``jax.lax.top_k`` does (``torch.topk`` promises no
    order among ties).
    """
    rho, num, den = masked_window_ratio(hist, num_masks, den_masks)
    if max_top_k > 0:
        top_rho, top_sites = torch.sort(rho, dim=1, descending=True,
                                        stable=True)
        top_rho = top_rho[:, :max_top_k]
        top_sites = top_sites[:, :max_top_k].to(torch.int32)
    else:
        top_rho = rho.new_zeros((rho.shape[0], 0))
        top_sites = torch.zeros((rho.shape[0], 0), dtype=torch.int32,
                                device=rho.device)
    site_rows = hist[sites.to(torch.int64)]
    return rho, num, den, top_rho, top_sites, site_rows


def answers_to_host(outputs) -> tuple:
    """The batched outputs copied to the host, as numpy arrays (the first
    copy waits for the device)."""
    return tuple(x.cpu().numpy() for x in outputs)


def decode_answers(batch: QueryBatch, outputs) -> list:
    """Split the batched outputs into per-spec QueryAnswers (copies them
    to the host, which waits for the device)."""
    return split_answers(batch, answers_to_host(outputs))


def split_answers(batch: QueryBatch, host: tuple) -> list:
    """Split ``answers_to_host``'s arrays into per-spec QueryAnswers."""
    rho, num, den, top_rho, top_sites, site_rows = host
    answers = []
    for i, spec in enumerate(batch.specs):
        ans = QueryAnswer(spec=spec, rho=rho[i], num=num[i], den=den[i])
        if spec.top_k > 0:
            ans = dataclasses.replace(
                ans, top_sites=top_sites[i, :spec.top_k],
                top_rho=top_rho[i, :spec.top_k])
        if spec.site is not None:
            ans = dataclasses.replace(
                ans, site_rho=float(rho[i, spec.site]),
                site_total=site_rows[i, :, 0],
                site_marked=site_rows[i, :, 1])
        answers.append(ans)
    return answers


def growing_window_specs(statistic: str = "B",
                         num_weeks: int = WEEKS_PER_YEAR) -> list:
    """The paper's MalStone B window sequence as query specs (week 1..W)."""
    return [QuerySpec(statistic=statistic, window=w)
            for w in growing_monitor_windows(num_weeks)]


def default_query_mix(num_weeks: int = WEEKS_PER_YEAR,
                      num_sites: int = 1, top_k: int = 8) -> list:
    """A small mixed batch touching every answer block."""
    mid = (num_weeks // 2) * SECONDS_PER_WEEK
    year = WindowSpec(0, SECONDS_PER_YEAR, 0, SECONDS_PER_YEAR)
    half = WindowSpec(0, SECONDS_PER_YEAR, mid, SECONDS_PER_YEAR)
    return [
        QuerySpec(statistic="A", window=year),
        QuerySpec(statistic="A", window=half),
        QuerySpec(statistic="B", window=WindowSpec(
            0, SECONDS_PER_YEAR, 0, mid or SECONDS_PER_YEAR)),
        QuerySpec(statistic="B", window=year, top_k=min(top_k, num_sites)),
        QuerySpec(statistic="B-fixed", window=year,
                  site=max(0, num_sites - 1)),
    ]
