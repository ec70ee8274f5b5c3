"""MalGen's inverse-CDF site sampler.

Counterpart of ``repro/kernels/powerlaw_sample/ops.py:powerlaw_sample``: f32
draws ``u`` ``[n]`` and the f32 inclusive CDF ``[S]`` -> int32 site indices
``[n]``, ``searchsorted(cdf, u, side="right")`` clipped to ``[0, S-1]``. On
a CUDA tensor the wrapper launches K6 (``csrc/powerlaw_sample.cu``: a guide
table of the CDF, then a search per draw inside its bucket's bracket); on a
CPU tensor it runs ``powerlaw_sample_plain``. Launches are counted in
``powerlaw_sample.launches``; ``launch_plan`` mirrors the C entry point's
launches for the static analysis (``repro_torch.kernels._launch``).

A NaN draw gives ``S - 1``, as ``powerlaw_sample_ref`` does. The JAX Pallas
body counts ``cdf <= u``, which never holds for NaN, and gives 0 there
(ROADMAP.md Queue 3).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels._build import bind, kernel_attributes, library
from repro_torch.kernels._launch import Launch, cdiv, dim3

_INT32_MAX = 2**31 - 1
# K6's constants (csrc/powerlaw_sample.cu)
GUIDE = 1 << 13                  # buckets of the guide table
THREADS = 512                    # sample_kernel's block
BLOCKS_PER_SM = 3
GUIDE_THREADS = 256
DIRECT_THREADS = 256
DIRECT = 1 << 18                 # fewer draws: no table
SHARED_BYTES = (GUIDE + 4) * 4   # the table in sample_kernel's shared memory
SMEM_DEFAULT = 48 * 1024
# sample_kernel forms the end i + 4 of a group of four draws in an int
MAX_DRAWS = 2**31 - 4

# the source's kernels, in the order of its kernel_attributes entry point
KERNELS = ("direct_kernel", "guide_kernel", "sample_kernel")
# static shared memory of each kernel (none; sample_kernel's table is
# dynamic); chip_smoke.py holds this table against the card's
STATIC_SMEM_BYTES = {"direct_kernel": 0, "guide_kernel": 0,
                     "sample_kernel": 0}
# the index type each kernel forms its offsets into an array in
# (csrc/powerlaw_sample.cu:76-237)
INDEX_TYPES = {
    "direct_kernel": {"draws": "int32", "cdf": "int32"},
    "guide_kernel": {"cdf": "int64", "guide": "int32"},
    "sample_kernel": {"draws": "int32", "draw groups": "int32",
                      "cdf": "int32"},
}
# argument kinds of K6's C entry point, as declared in its source
SIGNATURES = {"powerlaw_sample": "ppppqip", "kernel_attributes": "ip"}


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


def attributes() -> dict:
    """What the card reports for each kernel (``_build.kernel_attributes``)."""
    return kernel_attributes(_lib(), KERNELS)


def _check_shape(n: int, s: int) -> None:
    if min(n, s) < 1 or n > MAX_DRAWS or s > _INT32_MAX:
        raise ValueError(f"powerlaw_sample: n={n}, S={s}; n must be in "
                         f"[1, 2^31 - 4] and S in [1, 2^31)")


def launch_plan(n: int, num_sites: int, sm_count: int) -> list:
    """The launches of ``powerlaw_sample`` (K6) for n draws under an
    S-entry CDF (csrc/powerlaw_sample.cu:255-287): below 2^18 draws a
    thread a draw; else the guide table, then a persistent grid of at most
    ``BLOCKS_PER_SM`` blocks an SM over groups of four draws."""
    _check_shape(n, num_sites)
    if n < DIRECT:
        grid = cdiv(n, DIRECT_THREADS)
        return [Launch("direct_kernel", dim3(grid), dim3(DIRECT_THREADS),
                       offsets={"draws": grid * DIRECT_THREADS - 1,
                                "cdf": num_sites})]
    groups = cdiv(n, 4)
    grid = min(cdiv(groups, THREADS), sm_count * BLOCKS_PER_SM)
    guide_grid = num_sites // GUIDE_THREADS + 1
    return [
        Launch("guide_kernel", dim3(guide_grid), dim3(GUIDE_THREADS),
               offsets={"cdf": guide_grid * GUIDE_THREADS - 1,
                        "guide": GUIDE + 1}),
        Launch("sample_kernel", dim3(grid), dim3(THREADS), SHARED_BYTES,
               opt_in=SHARED_BYTES if SHARED_BYTES > SMEM_DEFAULT else None,
               # the last group's end i + 4; a thread's group after its
               # last, g + stride
               offsets={"draws": 4 * groups,
                        "draw groups": groups - 1 + grid * THREADS,
                        "cdf": num_sites})]


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
    device; 1 <= n <= 2^31 - 4, 1 <= S < 2^31."""
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
    _check_shape(n, s)
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


def analysis_cases() -> list:
    """The shapes the kernel passes check ``launch_plan`` at: JAX's case
    (2^15 draws under the B preset's 100,000 sites), the main path's
    2^23, both sides of the direct-search limit 2^18, and the most draws
    the wrapper takes."""
    def case(name, n, s):
        def run(device):
            powerlaw_sample(torch.zeros(n, device=device),
                            torch.zeros(s, device=device))

        return {"name": f"powerlaw_sample/{name}", "source": "powerlaw_sample",
                "shape": (n, s), "plan": lambda sms: launch_plan(n, s, sms),
                "run": run, "index_types": INDEX_TYPES,
                "static_smem": STATIC_SMEM_BYTES}

    return [case("b_preset", 1 << 15, 100_000),
            case("main_path", 1 << 23, 100_000),
            case("direct_limit", DIRECT - 1, 100_000),
            case("table_limit", DIRECT, 100_000),
            case("most_draws", MAX_DRAWS, 100_000)]
