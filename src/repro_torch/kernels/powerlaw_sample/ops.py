"""MalGen's inverse-CDF site sampler.

Counterpart of ``repro/kernels/powerlaw_sample/ops.py:powerlaw_sample``: f32
draws ``u`` ``[n]`` and the f32 inclusive CDF ``[S]`` -> int32 site indices
``[n]``, ``searchsorted(cdf, u, side="right")`` clipped to ``[0, S-1]``. On
a CUDA tensor the wrapper launches K6 (``csrc/powerlaw_sample.cu``: a guide
table of the CDF, then a search per draw inside its bucket's bracket); on a
CPU tensor it runs ``powerlaw_sample_plain``. Launches are counted in
``powerlaw_sample.launches``.

A NaN draw gives ``S - 1``, as ``powerlaw_sample_ref`` does. The JAX Pallas
body counts ``cdf <= u``, which never holds for NaN, and gives 0 there
(ROADMAP.md Queue 3).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels._build import bind, library

_INT32_MAX = 2**31 - 1
# argument kinds of K6's C entry point, as declared in its source
SIGNATURES = {"powerlaw_sample": "ppppqip"}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = bind(library("powerlaw_sample"), SIGNATURES)
    lib.powerlaw_sample_scratch.argtypes = []
    lib.powerlaw_sample_scratch.restype = ctypes.c_int
    return lib


@functools.cache
def _scratch_bytes() -> int:
    """Bytes of K6's guide table."""
    return _lib().powerlaw_sample_scratch()


def powerlaw_sample_plain(u: torch.Tensor, cdf: torch.Tensor) -> torch.Tensor:
    """Plain version of K6: the Pallas body's comparison count, ``sum_s
    1{cdf[s] <= u}``, then the NaN rule and the clip.

    The count is taken by a stable merge rather than by comparing every
    draw with every entry (8.4e11 compares at n = 2^23, S = 100,000, about
    7 s a call on the card): the S entries and the n draws are sorted
    together, entries ahead of draws on ties, and a draw's count is the
    number of entries ahead of it. Adding 0.0 turns -0.0 into +0.0 first,
    so a zero draw and a zero entry tie in the sort as they do under
    ``<=``. It needs no order of the CDF and shares nothing with K6's
    search or ``torch.searchsorted``.
    """
    n, s = u.shape[0], cdf.shape[0]
    order = torch.sort(torch.cat([cdf, u]) + 0.0, stable=True).indices
    ahead = torch.cumsum((order < s).to(torch.int64), 0)
    count = torch.empty_like(ahead)
    count[order] = ahead               # back to the input order
    count = torch.where(torch.isnan(u), s - 1, count[s:])
    return count.clamp(0, s - 1).to(torch.int32)


def powerlaw_sample(u: torch.Tensor, cdf: torch.Tensor) -> torch.Tensor:
    """int32 ``[n]`` site indices of the f32 draws ``u`` ``[n]`` under the
    f32 inclusive CDF ``[S]`` (non-decreasing), both contiguous and on one
    device; 1 <= n, S < 2^31."""
    for name, t in (("u", u), ("cdf", cdf)):
        if t.dtype != torch.float32 or t.dim() != 1:
            raise ValueError(f"powerlaw_sample: {name} must be float32 [n],"
                             f" got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"powerlaw_sample: {name} must be contiguous")
    if cdf.device != u.device:
        raise ValueError(f"powerlaw_sample: cdf on {cdf.device}, u on "
                         f"{u.device}")
    n, s = u.shape[0], cdf.shape[0]
    if min(n, s) < 1 or max(n, s) > _INT32_MAX:
        raise ValueError(f"powerlaw_sample: n={n}, S={s}; each must be in "
                         f"[1, 2^31)")
    if u.device.type != "cuda":
        return powerlaw_sample_plain(u, cdf)
    out = torch.empty(n, dtype=torch.int32, device=u.device)
    # K6's guide table (built by calls of 2^18 draws or more)
    guide = torch.empty(_scratch_bytes(), dtype=torch.uint8, device=u.device)
    powerlaw_sample.launches += 1
    err = _lib().powerlaw_sample(
        u.data_ptr(), cdf.data_ptr(), out.data_ptr(), guide.data_ptr(), n, s,
        torch.cuda.current_stream(u.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"powerlaw_sample: CUDA launch failed with error "
                           f"{err}")
    return out


powerlaw_sample.launches = 0
