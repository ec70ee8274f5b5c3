"""The window-ratio kernels: MalStone B's finalizer and the serving
engine's batched query reducer.

Counterparts of ``repro/kernels/windowed_ratio/ops.py``:

- ``windowed_ratio`` (JAX ``:22``): hist int32 ``[S, W, 2]`` -> (rho f32,
  cum_total i32, cum_marked i32), each ``[S, W]``: the running weekly sums
  of both channels and their ratio. On a CUDA tensor the wrapper launches
  K7 (``csrc/windowed_ratio.cu``, a warp per site); on a CPU tensor it runs
  ``windowed_ratio_plain``. ``core/spm.py:malstone_b`` calls it on CUDA
  histograms.
- ``masked_window_ratio`` (JAX ``:40``): hist int32 ``[S, W, 2]`` and N
  numerator / denominator week masks (bool ``[N, W]``) -> (rho f32, num
  i32, den i32), each ``[N, S]``: row n answers query n over every site.
  On a CUDA tensor the wrapper launches K5
  (``csrc/windowed_ratio_masked.cu``); on a CPU tensor it runs
  ``masked_window_ratio_plain``.

Launches are counted in ``windowed_ratio.launches`` and
``masked_window_ratio.launches``. The sums are exact int32 sums (wrapping
past 2^31, as the JAX references' int32 cumsum and contraction do). The
JAX Pallas kernels sum in f32: they are exact only while a count stays
under 2^24, and ``_kernel``'s cast saturates past 2^31 (ROADMAP.md
Queue 3).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.common.types import safe_ratio
from repro_torch.kernels._build import bind, library
from repro_torch.kernels.windowed_ratio.ref import windowed_ratio_ref

_INT32_MAX = 2**31 - 1


# argument kinds of K7's C entry point, as declared in its source
SIGNATURES = {"windowed_ratio": "ppppiip"}


@functools.cache
def _finalize_lib() -> ctypes.CDLL:
    return bind(library("windowed_ratio"), SIGNATURES)


def windowed_ratio_plain(hist: torch.Tensor):
    """Plain version of K7: ``windowed_ratio_ref``, the two int32
    ``cumsum``s and ``safe_ratio``."""
    return windowed_ratio_ref(hist)


def windowed_ratio(hist: torch.Tensor):
    """(rho f32, cum_total i32, cum_marked i32) ``[S, W]`` of ``hist``
    int32 ``[S, W, 2]`` (contiguous); 1 <= S, W < 2^31."""
    if hist.dtype != torch.int32 or hist.dim() != 3 or hist.shape[2] != 2:
        raise ValueError(f"windowed_ratio: hist must be int32 [S, W, 2], "
                         f"got {hist.dtype} {tuple(hist.shape)}")
    s, w, _ = hist.shape
    if min(s, w) < 1 or max(s, w) > _INT32_MAX:
        raise ValueError(f"windowed_ratio: S={s}, W={w}; each must be in "
                         f"[1, 2^31)")
    if not hist.is_contiguous():
        raise ValueError("windowed_ratio: hist must be contiguous")
    if hist.device.type != "cuda":
        return windowed_ratio_plain(hist)
    rho = torch.empty(s, w, dtype=torch.float32, device=hist.device)
    cum_total = torch.empty(s, w, dtype=torch.int32, device=hist.device)
    cum_marked = torch.empty_like(cum_total)
    windowed_ratio.launches += 1
    err = _finalize_lib().windowed_ratio(
        hist.data_ptr(), rho.data_ptr(), cum_total.data_ptr(),
        cum_marked.data_ptr(), s, w,
        torch.cuda.current_stream(hist.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"windowed_ratio: CUDA launch failed with error "
                           f"{err}")
    return rho, cum_total, cum_marked


windowed_ratio.launches = 0


# argument kinds of K5's C entry point, as declared in its source
MASKED_SIGNATURES = {"masked_window_ratio": "pppppppiiip"}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = bind(library("windowed_ratio_masked"), MASKED_SIGNATURES)
    lib.masked_window_ratio_scratch.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.masked_window_ratio_scratch.restype = ctypes.c_longlong
    return lib


@functools.lru_cache(maxsize=64)
def _scratch_bytes(num_weeks: int, num_queries: int) -> int:
    """Bytes of K5's run lists for W weeks and N queries."""
    return _lib().masked_window_ratio_scratch(num_weeks, num_queries)


def masked_window_ratio_plain(hist: torch.Tensor, num_masks: torch.Tensor,
                              den_masks: torch.Tensor):
    """Plain version of K5: one int32 multiply-add of ``[N, S]`` per week
    and channel, then ``safe_ratio``."""
    n, s = num_masks.shape[0], hist.shape[0]
    num = torch.zeros(n, s, dtype=torch.int32, device=hist.device)
    den = torch.zeros_like(num)
    for w in range(hist.shape[1]):
        num += num_masks[:, w, None].to(torch.int32) * hist[None, :, w, 1]
        den += den_masks[:, w, None].to(torch.int32) * hist[None, :, w, 0]
    return safe_ratio(num, den), num, den


def masked_window_ratio(hist: torch.Tensor, num_masks: torch.Tensor,
                        den_masks: torch.Tensor):
    """(rho f32, num i32, den i32) ``[N, S]`` of the masked week sums of
    ``hist`` int32 ``[S, W, 2]`` (contiguous) under bool ``[N, W]`` masks
    (contiguous, on the same device); N, W, S >= 1."""
    if hist.dtype != torch.int32 or hist.dim() != 3 or hist.shape[2] != 2:
        raise ValueError(f"masked_window_ratio: hist must be int32 [S, W, 2]"
                         f", got {hist.dtype} {tuple(hist.shape)}")
    s, w, _ = hist.shape
    for name, m in (("num_masks", num_masks), ("den_masks", den_masks)):
        if m.dtype != torch.bool or m.dim() != 2 or m.shape[1] != w:
            raise ValueError(f"masked_window_ratio: {name} must be bool "
                             f"[N, {w}], got {m.dtype} {tuple(m.shape)}")
        if m.device != hist.device:
            raise ValueError(f"masked_window_ratio: {name} on {m.device}, "
                             f"hist on {hist.device}")
        if not m.is_contiguous():
            raise ValueError(f"masked_window_ratio: {name} must be "
                             f"contiguous")
    if num_masks.shape != den_masks.shape:
        raise ValueError(f"masked_window_ratio: num/den mask shapes differ: "
                         f"{tuple(num_masks.shape)} vs "
                         f"{tuple(den_masks.shape)}")
    n = num_masks.shape[0]
    if min(n, s, w) < 1 or max(n, s, w) > _INT32_MAX:
        raise ValueError(f"masked_window_ratio: N={n}, S={s}, W={w}; each "
                         f"must be in [1, 2^31)")
    if not hist.is_contiguous():
        raise ValueError("masked_window_ratio: hist must be contiguous")
    if hist.device.type != "cuda":
        return masked_window_ratio_plain(hist, num_masks, den_masks)
    rho = torch.empty(n, s, dtype=torch.float32, device=hist.device)
    num = torch.empty(n, s, dtype=torch.int32, device=hist.device)
    den = torch.empty_like(num)
    # the masks' run lists, written by the kernel's first launch
    runs = torch.empty(_scratch_bytes(w, n), dtype=torch.uint8,
                       device=hist.device)
    masked_window_ratio.launches += 1
    err = _lib().masked_window_ratio(
        hist.data_ptr(), num_masks.data_ptr(), den_masks.data_ptr(),
        runs.data_ptr(), rho.data_ptr(), num.data_ptr(), den.data_ptr(), s,
        w, n, torch.cuda.current_stream(hist.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"masked_window_ratio: CUDA launch failed with "
                           f"error {err}")
    return rho, num, den


masked_window_ratio.launches = 0
