"""Record and statistic contracts of the PyTorch port.

Counterpart of ``repro/common/types.py``: the same constants, the same
one-word shuffle layout and the same ``safe_ratio``. The port keeps its own
copy because it imports nothing from the JAX package.

Layout differences from the JAX package:

- Packed words are int32 *bit patterns*, not uint32: torch has no shifts on
  ``uint32`` tensors. A site >= 2^23 sets bit 31, so every right shift is
  followed by a mask.
- ``event_seq`` and ``shard_hash`` are int32 bit patterns of the uint32
  values the JAX package stores (view them as uint32 to compare).
- A log may carry a leading ``[P]`` axis: the P nodes of the JAX mesh are
  one axis of one tensor here.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

SECONDS_PER_DAY = 86_400
SECONDS_PER_WEEK = 7 * SECONDS_PER_DAY
SECONDS_PER_YEAR = 365 * SECONDS_PER_DAY
WEEKS_PER_YEAR = 52

# Sentinel for "entity never becomes marked" (int32 max).
NEVER_MARKED = 2**31 - 1

# Packed shuffle word (see repro/common/types.py for the rationale):
#     bit 31..8 site, bit 7..2 week, bit 1 mark, bit 0 valid.
# An invalid record packs to the all-zero word.
PACK_SITE_BITS = 24
PACK_WEEK_BITS = 6
PACK_MAX_SITES = 1 << PACK_SITE_BITS
PACK_MAX_WEEKS = 1 << PACK_WEEK_BITS
PACK_SITE_SHIFT = 8
PACK_WEEK_SHIFT = 2
PACK_MARK_SHIFT = 1

# shard_hash of padding rows: 0xFFFFFFFF as an int32 bit pattern.
PAD_SHARD_HASH = -1


def pack_site_week_mark(site: torch.Tensor, week: torch.Tensor,
                        mark: torch.Tensor,
                        valid: torch.Tensor) -> torch.Tensor:
    """One int32 word per record (bit pattern of the JAX uint32 word).

    ``site`` must be in ``[0, PACK_MAX_SITES)`` and ``week`` in
    ``[0, PACK_MAX_WEEKS)`` for valid rows; invalid rows pack to 0. The
    int32 left shift wraps, which is the bit pattern wanted.
    """
    word = ((site.to(torch.int32) << PACK_SITE_SHIFT)
            | (week.to(torch.int32) << PACK_WEEK_SHIFT)
            | ((mark > 0).to(torch.int32) << PACK_MARK_SHIFT)
            | 1)
    return torch.where(valid, word, torch.zeros_like(word))


def unpack_site_week_mark(word: torch.Tensor):
    """Inverse of ``pack_site_week_mark``: int32 ``(site, week, mark)`` and
    bool ``valid``."""
    valid = (word & 1) > 0
    mark = (word >> PACK_MARK_SHIFT) & 1
    week = (word >> PACK_WEEK_SHIFT) & (PACK_MAX_WEEKS - 1)
    site = (word >> PACK_SITE_SHIFT) & (PACK_MAX_SITES - 1)
    return site, week, mark, valid


class EventLog(NamedTuple):
    """Site-entity-mark events as a struct of int32 tensors.

    Every column shares the record shape: ``[N]`` for a flat log, or
    ``[P, n]`` when each of the P nodes holds its own shard. ``mark`` is
    the joined mark flag of paper §4; ``valid`` (bool) marks padding rows,
    ``None`` meaning every row is valid.
    """

    site_id: torch.Tensor
    entity_id: torch.Tensor
    timestamp: torch.Tensor
    mark: torch.Tensor
    event_seq: Optional[torch.Tensor] = None
    shard_hash: Optional[torch.Tensor] = None
    valid: Optional[torch.Tensor] = None

    @property
    def num_records(self) -> int:
        return self.site_id.numel()

    def valid_mask(self) -> torch.Tensor:
        if self.valid is None:
            return torch.ones(self.site_id.shape, dtype=torch.bool,
                              device=self.site_id.device)
        return self.valid

    def week(self, seconds_per_week: int = SECONDS_PER_WEEK,
             num_weeks: int = WEEKS_PER_YEAR) -> torch.Tensor:
        """Paper Reducer's time bucketing: timestamps -> week index."""
        w = torch.div(self.timestamp, seconds_per_week, rounding_mode="floor")
        return w.clamp(0, num_weeks - 1).to(torch.int32)

    def map(self, fn) -> "EventLog":
        """Apply ``fn`` to every present column."""
        return EventLog(*[None if c is None else fn(c) for c in self])

    def to(self, device) -> "EventLog":
        return self.map(lambda c: c.to(device))


class WindowSpec(NamedTuple):
    """Exposure + monitor window pair (paper Section 3.2, Figure 1), each
    half-open ``[start, end)`` in seconds since year start. MalStone A uses
    one pair covering the year; MalStone B a fixed exposure window and
    monitor windows sharing ``mon_start`` with growing ends."""

    exp_start: int
    exp_end: int
    mon_start: int
    mon_end: int

    @staticmethod
    def full_year() -> "WindowSpec":
        return WindowSpec(0, SECONDS_PER_YEAR, 0, SECONDS_PER_YEAR)


class SpmResult(NamedTuple):
    """``rho`` (float32) with the integer counts it was divided from."""

    rho: torch.Tensor
    total: torch.Tensor
    marked: torch.Tensor


def safe_ratio(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """``num/den`` in float32 with 0/0 -> 0 (one IEEE divide, no fast
    math), bit-equal to the JAX package's ``safe_ratio``."""
    den_f = den.to(torch.float32)
    q = num.to(torch.float32) / torch.clamp(den_f, min=1.0)
    return torch.where(den_f > 0, q, torch.zeros_like(q))


EXCHANGE_IMPLS = ("auto", "sort", "counting", "columns")
HISTOGRAM_IMPLS = ("segment_sum", "kernel")


@dataclasses.dataclass(frozen=True)
class ExchangePlan:
    """How the MapReduce backend moves and reduces records.

    - ``impl``: ``"counting"`` (stable counting sort of packed words by
      destination, the kernels K1 and K2), ``"sort"`` (stable argsort, its
      oracle), ``"columns"`` (the 4-column exchange, re-ordered every
      round) or ``"auto"`` (counting whenever the one-word projection
      represents the workload, else columns).
    - ``capacity_factor``: per-destination bucket capacity as a fraction
      of ``records / P``; any value is lossless, smaller runs more rounds.
    - ``max_shuffle_rounds``: explicit round cap (``None`` = the provably
      sufficient bound); exhausting it raises ``ShuffleExhaustedError``.
    - ``histogram_impl``: ``"kernel"`` (the default) reduces with the
      hand-written kernels: K4 for every local combine and the columns
      reducer, the fused unpack+histogram K3 for shuffled words;
      ``"segment_sum"`` unpacks and histograms with ``index_add_``.
    """

    impl: str = "auto"
    capacity_factor: float = 2.0
    max_shuffle_rounds: Optional[int] = None
    histogram_impl: str = "kernel"

    def __post_init__(self):
        if self.impl not in EXCHANGE_IMPLS:
            raise ValueError(
                f"ExchangePlan.impl must be one of {EXCHANGE_IMPLS}, "
                f"got {self.impl!r}")
        if self.histogram_impl not in HISTOGRAM_IMPLS:
            raise ValueError(
                f"ExchangePlan.histogram_impl must be one of "
                f"{HISTOGRAM_IMPLS}, got {self.histogram_impl!r}")
        if self.capacity_factor <= 0:
            raise ValueError(
                f"ExchangePlan.capacity_factor must be > 0, "
                f"got {self.capacity_factor}")
        if self.max_shuffle_rounds is not None and self.max_shuffle_rounds < 1:
            raise ValueError(
                f"ExchangePlan.max_shuffle_rounds must be >= 1 (or None), "
                f"got {self.max_shuffle_rounds}")
