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
``masked_window_ratio.launches``; ``launch_plan`` and ``masked_launch_plan``
mirror the C entry points' launches for the static analysis
(``repro_torch.kernels._launch``). The sums are exact int32 sums (wrapping
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
from repro_torch.kernels._build import bind, kernel_attributes, library
from repro_torch.kernels._launch import Launch, cdiv, dim3
from repro_torch.kernels.windowed_ratio.ref import windowed_ratio_ref

_INT32_MAX = 2**31 - 1

# K7's constants (csrc/windowed_ratio.cu)
THREADS = 256
BLOCKS_PER_SM = 8
WEEK_CHUNK = 64
# K7 forms a lane's week offset 2w + 3 in an int (load_weeks)
MAX_WEEKS = 2**30 - 1
# K5's constants (csrc/windowed_ratio_masked.cu)
MASKED_THREADS = 256
MASKED_WARPS = MASKED_THREADS // 32
SITE_TILE = 64
QUERY_BLOCK = 64
ROW_ALIGN = 16
# K5's host forms num_sites + 63 and the run-list rows (+ 7) in ints
MAX_MASKED_SITES = 2**31 - 64
MAX_RUN_ROWS = 2**31 - 8
SMEM_DEFAULT = 48 * 1024

# each source's kernels, in the order of its kernel_attributes entry point
KERNELS = {"windowed_ratio": ("windowed_ratio_kernel",),
           "windowed_ratio_masked": ("mask_runs_kernel",
                                     "masked_window_ratio_kernel")}
# static shared memory of each kernel (none, or dynamic only);
# chip_smoke.py holds this table against the card's
STATIC_SMEM_BYTES = {"windowed_ratio_kernel": 0, "mask_runs_kernel": 0,
                     "masked_window_ratio_kernel": 0}
# the index type each kernel forms its offsets into an array in
# (csrc/windowed_ratio.cu:59-150, csrc/windowed_ratio_masked.cu:112-361)
INDEX_TYPES = {
    "windowed_ratio_kernel": {"hist": "int64", "hist (in a row)": "int32",
                              "sites": "int32", "outputs": "int64"},
    "mask_runs_kernel": {"run rows": "int32", "masks": "int64"},
    "masked_window_ratio_kernel": {"sites": "int32", "hist": "int64",
                                   "runs": "int64", "answers": "int64"},
}


# argument kinds of K7's C entry point, as declared in its source
SIGNATURES = {"windowed_ratio": "ppppiip", "kernel_attributes": "ip"}


@functools.cache
def _finalize_lib() -> ctypes.CDLL:
    return bind(library("windowed_ratio"), SIGNATURES)


def attributes(source: str) -> dict:
    """What the card reports for each kernel of ``source``
    (``_build.kernel_attributes``)."""
    lib = _finalize_lib() if source == "windowed_ratio" else _lib()
    return kernel_attributes(lib, KERNELS[source])


def launch_plan(num_sites: int, num_weeks: int, sm_count: int) -> list:
    """The launch of ``windowed_ratio`` (K7) on a ``[S, W, 2]`` histogram
    (csrc/windowed_ratio.cu:163-179): a persistent grid of at most
    ``BLOCKS_PER_SM`` blocks an SM, a warp a site."""
    _check_k7_shape(num_sites, num_weeks)
    grid = min(cdiv(num_sites, THREADS // 32), sm_count * BLOCKS_PER_SM)
    return [Launch(
        "windowed_ratio_kernel", dim3(grid), dim3(THREADS),
        offsets={"hist": num_sites * num_weeks * 2 - 1,
                 # load_weeks' 2w + 3 for w < W; the host's W + 63
                 "hist (in a row)": max(2 * num_weeks + 1,
                                        num_weeks + WEEK_CHUNK - 1),
                 "sites": grid * (THREADS // 32) - 1,
                 "outputs": num_sites * num_weeks - 1})]


def _check_k7_shape(s: int, w: int) -> None:
    if min(s, w) < 1 or s > _INT32_MAX or w > MAX_WEEKS:
        raise ValueError(f"windowed_ratio: S={s}, W={w}; S must be in "
                         f"[1, 2^31) and W in [1, 2^30)")


def windowed_ratio_plain(hist: torch.Tensor):
    """Plain version of K7: ``windowed_ratio_ref``, the two int32
    ``cumsum``s and ``safe_ratio``."""
    return windowed_ratio_ref(hist)


def windowed_ratio(hist: torch.Tensor):
    """(rho f32, cum_total i32, cum_marked i32) ``[S, W]`` of ``hist``
    int32 ``[S, W, 2]`` (contiguous); 1 <= S < 2^31, 1 <= W < 2^30."""
    if hist.dtype != torch.int32 or hist.dim() != 3 or hist.shape[2] != 2:
        raise ValueError(f"windowed_ratio: hist must be int32 [S, W, 2], "
                         f"got {hist.dtype} {tuple(hist.shape)}")
    s, w, _ = hist.shape
    _check_k7_shape(s, w)
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
MASKED_SIGNATURES = {"masked_window_ratio": "pppppppiiip",
                     "kernel_attributes": "ip"}


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


def run_row(num_weeks: int) -> int:
    """Bytes of one run list: the wc + 1 changes of a week chunk, padded
    to 16."""
    wc = min(num_weeks, WEEK_CHUNK)
    return cdiv(wc + 1, ROW_ALIGN) * ROW_ALIGN


def masked_smem_bytes(num_weeks: int, num_queries: int) -> int:
    """K5's dynamic shared memory (``smem_bytes`` in the source): the run
    lists of a query block, the prefix sums of a week chunk, the lists'
    lengths."""
    wc = min(num_weeks, WEEK_CHUNK)
    nq = min(num_queries, QUERY_BLOCK)
    return (2 * nq * run_row(num_weeks) + 2 * (wc + 1) * (SITE_TILE + 1) * 4
            + 2 * nq * 4)


def _check_k5_shape(n: int, s: int, w: int) -> None:
    if min(n, s, w) < 1 or max(n, w) > _INT32_MAX or s > MAX_MASKED_SITES:
        raise ValueError(f"masked_window_ratio: N={n}, S={s}, W={w}; each "
                         f"must be at least 1, N and W below 2^31, S at "
                         f"most 2^31 - 64")
    if cdiv(w, WEEK_CHUNK) * 2 * n > MAX_RUN_ROWS:
        raise ValueError(f"masked_window_ratio: N={n} queries over W={w} "
                         f"weeks make more than 2^31 - 8 run lists")


def masked_launch_plan(num_queries: int, num_sites: int,
                       num_weeks: int) -> list:
    """The launches of ``masked_window_ratio`` (K5) for N queries over a
    ``[S, W, 2]`` histogram (csrc/windowed_ratio_masked.cu:330-361): the
    masks' run lists, a warp a list, then a block a tile of 64 sites."""
    _check_k5_shape(num_queries, num_sites, num_weeks)
    chunks = cdiv(num_weeks, WEEK_CHUNK)
    rows = chunks * 2 * num_queries
    smem = masked_smem_bytes(num_weeks, num_queries)
    return [
        Launch("mask_runs_kernel", dim3(cdiv(rows, MASKED_WARPS)),
               dim3(MASKED_THREADS),
               offsets={"run rows": rows + MASKED_WARPS - 1,
                        "masks": num_queries * num_weeks - 1},
               covers=((rows, MASKED_WARPS),)),
        Launch("masked_window_ratio_kernel",
               dim3(cdiv(num_sites, SITE_TILE)), dim3(MASKED_THREADS), smem,
               opt_in=smem if smem > SMEM_DEFAULT else None,
               offsets={"sites": num_sites + SITE_TILE - 1,
                        "hist": num_sites * num_weeks * 2 - 1,
                        "runs": rows * run_row(num_weeks) - 1,
                        "answers": num_queries * num_sites - 1},
               covers=((num_sites, SITE_TILE),))]


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
    (contiguous, on the same device); N, W, S >= 1, S <= 2^31 - 64, and
    ``2 N ceil(W / 64)`` run lists at most 2^31 - 8."""
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
    _check_k5_shape(num_masks.shape[0], s, w)
    n = num_masks.shape[0]
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


def analysis_cases() -> list:
    """The shapes the kernel passes check the plans at: JAX's two cases
    (K7 on the B preset's ``[100,000, 52, 2]`` histogram, K5 with 64
    queries over it), NodeDoctor's K7 at ``[4, 8, 2]``, K5 over two week
    chunks and three query blocks, and the widest histograms the wrappers
    take."""
    def k7(name, s, w):
        def run(device):
            windowed_ratio(torch.zeros(s, w, 2, dtype=torch.int32,
                                       device=device))

        return {"name": f"windowed_ratio/{name}", "source": "windowed_ratio",
                "shape": (s, w), "plan": lambda sms: launch_plan(s, w, sms),
                "run": run, "index_types": INDEX_TYPES,
                "static_smem": STATIC_SMEM_BYTES}

    def k5(name, n, s, w):
        def run(device):
            masks = torch.zeros(n, w, dtype=torch.bool, device=device)
            masked_window_ratio(torch.zeros(s, w, 2, dtype=torch.int32,
                                            device=device), masks, masks)

        return {"name": f"windowed_ratio/{name}",
                "source": "windowed_ratio_masked", "shape": (n, s, w),
                "plan": lambda sms: masked_launch_plan(n, s, w), "run": run,
                "index_types": INDEX_TYPES, "static_smem": STATIC_SMEM_BYTES}

    return [k7("b_preset", 100_000, 52),
            k5("masked_batch64", 64, 100_000, 52),
            k7("nodedoctor", 4, 8),
            k5("masked_two_chunks", 129, 100_000, 130),
            k7("most_sites", _INT32_MAX, 1),
            k5("masked_most_sites", 1, MAX_MASKED_SITES, 1)]
