"""The MapReduce reducer's fused unpack + histogram over packed words.

Counterpart of ``repro/kernels/segment_hist/ops.py:segment_hist_packed_words``,
batched over the receiving nodes: ``words`` is int32 ``[P, L]``, row ``r``
holding the L words node ``r`` received. On a CUDA tensor the wrapper
launches K3 (``csrc/segment_hist_packed.cu``) once for all P nodes; on a
CPU tensor it runs ``segment_hist_packed_words_plain`` (unpack, then
``index_add_``). Launches are counted in
``segment_hist_packed_words.launches``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.common.types import WEEKS_PER_YEAR, unpack_site_week_mark
from repro_torch.kernels._build import library
from repro_torch.kernels.segment_hist.ref import segment_hist_ref


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = library("segment_hist_packed")
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.packed_hist.argtypes = [ptr, ptr, i64, i32, i32, i32, i32, ptr]
    lib.packed_hist.restype = i32
    return lib


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
