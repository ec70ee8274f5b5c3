"""Exposure / monitor window algebra (paper Section 3, Figure 1).

Counterpart of ``repro/core/windows.py``: MalStone B's monitor windows
share a start time and grow by one week per step; window specs become
week-bucket masks so the query reducer stays dense.
"""

from __future__ import annotations

import torch

from repro_torch.common.types import (
    SECONDS_PER_WEEK,
    SECONDS_PER_YEAR,
    WEEKS_PER_YEAR,
    WindowSpec,
)


def week_of(ts: torch.Tensor, num_weeks: int = WEEKS_PER_YEAR) -> torch.Tensor:
    w = torch.div(ts, SECONDS_PER_WEEK, rounding_mode="floor")
    return w.clamp(0, num_weeks - 1).to(torch.int32)


def growing_monitor_windows(num_weeks: int = WEEKS_PER_YEAR
                            ) -> list[WindowSpec]:
    """MalStone B's window sequence: year start -> end of week t."""
    return [WindowSpec(0, SECONDS_PER_YEAR, 0,
                       min(t * SECONDS_PER_WEEK, SECONDS_PER_YEAR))
            for t in range(1, num_weeks + 1)]


def in_window(ts: torch.Tensor, start: int, end: int) -> torch.Tensor:
    return (ts >= start) & (ts < end)


def week_mask_for_window(spec: WindowSpec,
                         num_weeks: int = WEEKS_PER_YEAR) -> torch.Tensor:
    """Bool ``[num_weeks]`` mask of the week buckets the monitor window
    covers, fully or partly. The last bucket ends at the year's end: it
    absorbs the year's tail, as ``week_of`` clamps it."""
    week_starts = torch.arange(num_weeks, dtype=torch.int64) * SECONDS_PER_WEEK
    week_ends = torch.clamp(week_starts + SECONDS_PER_WEEK,
                            max=SECONDS_PER_YEAR)
    week_ends[num_weeks - 1] = SECONDS_PER_YEAR
    return (week_starts < spec.mon_end) & (week_ends > spec.mon_start)
