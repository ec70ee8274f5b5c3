"""The (total, marked) site-week histogram kernels, batched over the nodes.

Counterpart of ``repro/kernels/segment_hist/ops.py``:

- ``segment_hist`` / ``segment_hist_eventlog`` (JAX ``ops.py:30`` and
  ``:59``) reduce int32 ``(site, week, mark, valid)`` columns of shape
  ``[P, n]`` into int32 ``[P, S, W, 2]``, one histogram per node. On a CUDA
  tensor the wrapper launches K4 (``csrc/segment_hist.cu``) once for all P
  nodes; on a CPU tensor it runs ``segment_hist_plain``.
- ``segment_hist_packed_words`` is the MapReduce reducer's fused unpack +
  histogram over shuffled words: row ``r`` of int32 ``[P, L]`` holds the L
  words node ``r`` received. On a CUDA tensor it launches K3
  (``csrc/segment_hist_packed.cu``); on a CPU tensor it runs
  ``segment_hist_packed_words_plain`` (unpack, then ``index_add_``).

Both count ``mark > 0``, as ``segment_hist_ref`` does; the JAX Pallas
``_kernel`` adds the raw mark value, which agrees only for marks in {0, 1}
(ROADMAP.md Queue 3). Launches are counted in ``segment_hist.launches`` and
``segment_hist_packed_words.launches``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.common.types import (
    EventLog,
    WEEKS_PER_YEAR,
    unpack_site_week_mark,
)
from repro_torch.kernels._build import library
from repro_torch.kernels.segment_hist.ref import segment_hist_ref

_MAX_NODES = 65_535          # gridDim.y of the launch
_INT32_MIN, _INT32_MAX = -2**31, 2**31 - 1


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = library("segment_hist_packed")
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.packed_hist.argtypes = [ptr, ptr, i64, i32, i32, i32, i32, ptr]
    lib.packed_hist.restype = i32
    return lib


@functools.cache
def _hist_lib() -> ctypes.CDLL:
    lib = library("segment_hist")
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.segment_hist.argtypes = [ptr, ptr, ptr, ptr, ptr, i64, i32, i32, i32,
                                 i32, ptr]
    lib.segment_hist.restype = i32
    return lib


def segment_hist_plain(site: torch.Tensor, week: torch.Tensor,
                       mark: torch.Tensor, valid: torch.Tensor, *,
                       num_sites: int, num_weeks: int = WEEKS_PER_YEAR,
                       site_offset: int = 0) -> torch.Tensor:
    """Plain version of K4: ``segment_hist_ref`` of the rebased sites."""
    return segment_hist_ref(site - site_offset, week, mark, valid,
                            num_sites, num_weeks)


def segment_hist(site: torch.Tensor, week: torch.Tensor, mark: torch.Tensor,
                 valid: torch.Tensor, *, num_sites: int,
                 num_weeks: int = WEEKS_PER_YEAR,
                 site_offset: int = 0) -> torch.Tensor:
    """int32 ``[P, num_sites, num_weeks, 2]`` (total, marked) histograms of
    ``[P, n]`` columns, one per row. ``site``, ``week`` and ``mark`` are
    int32, ``valid`` bool. A row counts where it is valid and ``site -
    site_offset`` and ``week`` are in range; ``marked`` counts ``mark >
    0``."""
    for name, t, dtype in (("site", site, torch.int32),
                           ("week", week, torch.int32),
                           ("mark", mark, torch.int32),
                           ("valid", valid, torch.bool)):
        if t.dim() != 2 or t.shape != site.shape:
            raise ValueError(f"segment_hist: {name} must be [P, n] like "
                             f"site {tuple(site.shape)}, got "
                             f"{tuple(t.shape)}")
        if t.dtype != dtype:
            raise ValueError(f"segment_hist: {name} must be {dtype}, got "
                             f"{t.dtype}")
        if t.device != site.device:
            raise ValueError(f"segment_hist: {name} on {t.device}, site on "
                             f"{site.device}")
        if not t.is_contiguous():
            raise ValueError(f"segment_hist: {name} must be contiguous")
    if num_sites < 1 or num_weeks < 1:
        raise ValueError(f"segment_hist: num_sites={num_sites}, "
                         f"num_weeks={num_weeks}")
    if not _INT32_MIN <= site_offset <= _INT32_MAX:
        raise ValueError(f"segment_hist: site_offset {site_offset} is not "
                         f"an int32")
    if site.device.type != "cuda":
        return segment_hist_plain(site, week, mark, valid,
                                  num_sites=num_sites, num_weeks=num_weeks,
                                  site_offset=site_offset)
    p, n = site.shape
    if p > _MAX_NODES:
        raise ValueError(f"segment_hist: {p} rows exceed the launch's "
                         f"{_MAX_NODES}")
    hist = torch.zeros(p, num_sites, num_weeks, 2, dtype=torch.int32,
                       device=site.device)
    segment_hist.launches += 1
    err = _hist_lib().segment_hist(
        site.data_ptr(), week.data_ptr(), mark.data_ptr(), valid.data_ptr(),
        hist.data_ptr(), n, p, num_sites, num_weeks, site_offset,
        torch.cuda.current_stream(site.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"segment_hist: CUDA launch failed with error "
                           f"{err}")
    return hist


segment_hist.launches = 0


def segment_hist_eventlog(log: EventLog, num_sites: int,
                          num_weeks: int = WEEKS_PER_YEAR,
                          site_offset: int = 0) -> torch.Tensor:
    """Drop-in for ``core.spm.site_week_histogram`` over a ``[P, n]`` log,
    backed by K4 on the card: int32 ``[P, num_sites, num_weeks, 2]``."""
    return segment_hist(
        log.site_id.contiguous(), log.week(num_weeks=num_weeks).contiguous(),
        log.mark.contiguous(), log.valid_mask().contiguous(),
        num_sites=num_sites, num_weeks=num_weeks, site_offset=site_offset)


def segment_hist_packed_words_plain(words: torch.Tensor, *,
                                    num_sites_local: int,
                                    num_partitions: int,
                                    num_weeks: int = WEEKS_PER_YEAR
                                    ) -> torch.Tensor:
    """Plain version: unpack, keep the words node ``r`` owns
    (``site % P == r``), rebase to ``site // P``, histogram."""
    site, week, mark, valid = unpack_site_week_mark(words)
    node = torch.arange(words.shape[0], device=words.device).unsqueeze(1)
    ok = valid & (site % num_partitions == node)
    return segment_hist_ref(site // num_partitions, week, mark, ok,
                            num_sites_local, num_weeks)


def segment_hist_packed_words(words: torch.Tensor, *, num_sites_local: int,
                              num_partitions: int,
                              num_weeks: int = WEEKS_PER_YEAR
                              ) -> torch.Tensor:
    """Owned int32 ``[P, num_sites_local, num_weeks, 2]`` histograms of the
    shuffled words, one per receiving node. Invalid slots are zero words;
    words that node r does not own, or whose rebased site or week is out
    of range, count nowhere."""
    if words.dtype != torch.int32 or words.dim() != 2:
        raise ValueError(f"segment_hist_packed_words: expected int32 "
                         f"[P, L] words, got {words.dtype} "
                         f"{tuple(words.shape)}")
    if words.shape[0] != num_partitions:
        raise ValueError(f"segment_hist_packed_words: {words.shape[0]} rows "
                         f"for {num_partitions} nodes")
    if not words.is_contiguous():
        raise ValueError("segment_hist_packed_words: words must be "
                         "contiguous")
    if num_sites_local < 1 or not 1 <= num_weeks <= 64:
        raise ValueError(f"segment_hist_packed_words: num_sites_local="
                         f"{num_sites_local}, num_weeks={num_weeks}")
    if words.device.type != "cuda":
        return segment_hist_packed_words_plain(
            words, num_sites_local=num_sites_local,
            num_partitions=num_partitions, num_weeks=num_weeks)
    p, length = words.shape
    hist = torch.zeros(p, num_sites_local, num_weeks, 2, dtype=torch.int32,
                       device=words.device)
    segment_hist_packed_words.launches += 1
    err = _lib().packed_hist(
        words.data_ptr(), hist.data_ptr(), length, p, num_partitions,
        num_sites_local, num_weeks,
        torch.cuda.current_stream(words.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"packed_hist: CUDA launch failed with error "
                           f"{err}")
    return hist


segment_hist_packed_words.launches = 0
