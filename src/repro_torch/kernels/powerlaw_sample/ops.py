"""MalGen's inverse-CDF site sampler.

Counterpart of ``repro/kernels/powerlaw_sample/ops.py:powerlaw_sample``: f32
draws ``u`` ``[n]`` and the f32 inclusive CDF ``[S]`` -> int32 site indices
``[n]``, ``searchsorted(cdf, u, side="right")`` clipped to ``[0, S-1]``. On
a CUDA tensor the wrapper launches K6 (``csrc/powerlaw_sample.cu``: a guide
table of the CDF, then a search per draw inside its bucket's bracket); on a
CPU tensor it runs ``powerlaw_sample_plain``. Launches are counted in
``powerlaw_sample.launches``; ``launch_plan`` mirrors the C entry point's
launches for the static analysis (``repro_torch.kernels._launch``).

``powerlaw_sample_join`` is K6 fused with MalGen's mark join: for one half
of a streaming chunk it writes the sites, the joined mark, the event ids
and the chunk's hash straight into the step's ``[P, C]`` columns
(``malgen/generator.py:generate_chunks``). Its launches count as K6's
(``powerlaw_sample.launches``, one a call), and its kernels keep K6's names
in a nested namespace (``join::sample_kernel``, ``join::direct_kernel``).
On a CPU tensor it runs ``powerlaw_sample_join_plain``.

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
JOIN_BLOCKS_PER_SM = 2           # join::sample_kernel
GUIDE_THREADS = 256
DIRECT_THREADS = 256
DIRECT = 1 << 18                 # fewer draws: no table
SHARED_BYTES = (GUIDE + 4) * 4   # the table in sample_kernel's shared memory
SMEM_DEFAULT = 48 * 1024
# sample_kernel forms the end i + 4 of a group of four draws in an int
MAX_DRAWS = 2**31 - 4

# the source's kernels, in the order of its kernel_attributes entry point
KERNELS = ("direct_kernel", "guide_kernel", "sample_kernel",
           "join::direct_kernel", "join::sample_kernel")
# static shared memory of each kernel (none; the sample kernels' table is
# dynamic); chip_smoke.py holds this table against the card's
STATIC_SMEM_BYTES = {"direct_kernel": 0, "guide_kernel": 0,
                     "sample_kernel": 0, "join::direct_kernel": 0,
                     "join::sample_kernel": 0}
# the index type each kernel forms its offsets into an array in
# (csrc/powerlaw_sample.cu)
INDEX_TYPES = {
    "direct_kernel": {"draws": "int32", "cdf": "int32"},
    "guide_kernel": {"cdf": "int64", "guide": "int32"},
    "sample_kernel": {"draws": "int32", "draw groups": "int32",
                      "cdf": "int32"},
    "join::direct_kernel": {"draws": "int32", "cdf": "int32",
                            "event ids": "int32"},
    "join::sample_kernel": {"draws": "int32", "draw groups": "int32",
                            "cdf": "int32", "event ids": "int32"},
}
# argument kinds of K6's C entry points, as declared in its source
SIGNATURES = {"powerlaw_sample": "ppppqip",
              "powerlaw_sample_join": "ppppppppppqiiip",
              "kernel_attributes": "ip"}


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


def join_launch_plan(n: int, num_sites: int, sm_count: int,
                     skew: int = 0) -> list:
    """The launches of ``powerlaw_sample_join`` for n records under an
    S-entry CDF whose slices lie ``skew`` ints past a 16-byte boundary
    (csrc/powerlaw_sample.cu:powerlaw_sample_join): below 2^18 records a
    thread a record; else the guide table, then a persistent grid of at
    most ``JOIN_BLOCKS_PER_SM`` blocks an SM over groups of four records,
    the first of them the head of ``4 - skew`` records."""
    _check_shape(n, num_sites)
    if n < DIRECT:
        grid = cdiv(n, DIRECT_THREADS)
        return [Launch("join::direct_kernel", dim3(grid),
                       dim3(DIRECT_THREADS),
                       offsets={"draws": grid * DIRECT_THREADS - 1,
                                "cdf": num_sites, "event ids": n})]
    groups = cdiv(n + skew, 4)
    grid = min(cdiv(groups, THREADS), sm_count * JOIN_BLOCKS_PER_SM)
    guide_grid = num_sites // GUIDE_THREADS + 1
    return [
        Launch("guide_kernel", dim3(guide_grid), dim3(GUIDE_THREADS),
               offsets={"cdf": guide_grid * GUIDE_THREADS - 1,
                        "guide": GUIDE + 1}),
        Launch("join::sample_kernel", dim3(grid), dim3(THREADS),
               SHARED_BYTES,
               opt_in=SHARED_BYTES if SHARED_BYTES > SMEM_DEFAULT else None,
               # the last group's end i + 4; a thread's group after its
               # last, g + stride; the event ids seq0 + i of a half that
               # starts at seq0 = 0
               offsets={"draws": 4 * groups - skew,
                        "draw groups": groups - 1 + grid * THREADS,
                        "cdf": num_sites, "event ids": n})]


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


def _check_join(u, cdf, mark_time, cols: dict, seq_start: int) -> None:
    for name, t, want in (("cdf", cdf, torch.float32),
                          ("mark_time", mark_time, torch.int32)):
        if t.dtype != want or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"powerlaw_sample_join: {name} must be a "
                             f"contiguous 1-d {want}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    n = u.shape[0] if u.dim() == 1 else -1
    for name, t in cols.items():
        want = torch.float32 if name == "u" else torch.int32
        if t.dtype != want or t.dim() != 1 or t.shape[0] != n:
            raise ValueError(f"powerlaw_sample_join: {name} must be {want} "
                             f"[{n}] beside u, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"powerlaw_sample_join: {name} must be "
                             f"contiguous")
    for name, t in (("cdf", cdf), ("mark_time", mark_time), *cols.items()):
        if t.device != u.device:
            raise ValueError(f"powerlaw_sample_join: {name} on {t.device}, "
                             f"u on {u.device}")
    _check_shape(n, cdf.shape[0])
    if mark_time.shape[0] < 1:
        raise ValueError("powerlaw_sample_join: mark_time is empty")
    if not 0 <= seq_start <= _INT32_MAX - n:
        raise ValueError(f"powerlaw_sample_join: event ids {seq_start} .. "
                         f"{seq_start + n - 1} leave int32")


def powerlaw_sample_join_plain(u, cdf, entity, timestamp, mark_time, site,
                               mark, event_seq, shard_hash, *,
                               seq_start: int, hash_value: int) -> None:
    """Plain version of the join pass: ``torch.searchsorted`` clipped to
    ``[0, S-1]``, the mark table gathered at the entities, the event ids
    and the hash, each written into its output."""
    found = torch.searchsorted(cdf, u, right=True)
    site.copy_(found.clamp(0, cdf.shape[0] - 1))
    mark.copy_(mark_time[entity.to(torch.int64)] <= timestamp)
    event_seq.copy_(torch.arange(seq_start, seq_start + u.shape[0],
                                 device=u.device))
    shard_hash.fill_(hash_value)


def powerlaw_sample_join(u: torch.Tensor, cdf: torch.Tensor,
                         entity: torch.Tensor, timestamp: torch.Tensor,
                         mark_time: torch.Tensor, site: torch.Tensor,
                         mark: torch.Tensor, event_seq: torch.Tensor,
                         shard_hash: torch.Tensor, *, seq_start: int,
                         hash_value: int) -> None:
    """K6's sites of the f32 draws ``u`` ``[n]`` under the f32 inclusive
    CDF ``[S]``, joined with MalGen's marks, written in place: ``site`` =
    K6's answer, ``mark`` = ``mark_time[entity] <= timestamp``,
    ``event_seq`` = ``seq_start + i``, ``shard_hash`` = ``hash_value``
    (int32 bits). Every column is contiguous ``[n]`` (slices of the step's
    rows), int32 but ``u``, on one device with ``cdf`` and the int32 mark
    table ``mark_time`` ``[E]``; entities must lie in ``[0, E)``. A CUDA
    call counts one K6 launch."""
    cols = {"u": u, "entity": entity, "timestamp": timestamp, "site": site,
            "mark": mark, "event_seq": event_seq, "shard_hash": shard_hash}
    _check_join(u, cdf, mark_time, cols, seq_start)
    if u.device.type != "cuda":
        powerlaw_sample_join_plain(u, cdf, entity, timestamp, mark_time,
                                   site, mark, event_seq, shard_hash,
                                   seq_start=seq_start,
                                   hash_value=hash_value)
        return
    guide = torch.empty(_scratch_bytes(), dtype=torch.uint8, device=u.device)
    powerlaw_sample.launches += 1
    err = _lib().powerlaw_sample_join(
        u.data_ptr(), cdf.data_ptr(), entity.data_ptr(),
        timestamp.data_ptr(), mark_time.data_ptr(), site.data_ptr(),
        mark.data_ptr(), event_seq.data_ptr(), shard_hash.data_ptr(),
        guide.data_ptr(), u.shape[0], cdf.shape[0], seq_start, hash_value,
        torch.cuda.current_stream(u.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"powerlaw_sample_join: CUDA launch failed with "
                           f"error {err}")


def analysis_cases() -> list:
    """The shapes the kernel passes check ``launch_plan`` at: JAX's case
    (2^15 draws under the B preset's 100,000 sites), the main path's
    2^23, both sides of the direct-search limit 2^18, and the most draws
    the wrapper takes; then the join pass (``join_launch_plan``) at the
    streaming step's two halves (120,000 sites, as the benchmark's B-10
    configurations) and below its direct-search limit."""
    def case(name, n, s):
        def run(device):
            powerlaw_sample(torch.zeros(n, device=device),
                            torch.zeros(s, device=device))

        return {"name": f"powerlaw_sample/{name}", "source": "powerlaw_sample",
                "shape": (n, s), "plan": lambda sms: launch_plan(n, s, sms),
                "run": run, "index_types": INDEX_TYPES,
                "static_smem": STATIC_SMEM_BYTES}

    def join_case(name, n, s, skew):
        def run(device):
            # every column at skew ints past the allocation's start, as the
            # unmarked half of a row lies
            u = torch.zeros(n + skew, device=device)[skew:]
            i32 = [torch.zeros(n + skew, dtype=torch.int32,
                               device=device)[skew:] for _ in range(6)]
            powerlaw_sample_join(
                u, torch.zeros(s, device=device), i32[0], i32[1],
                torch.zeros(1, dtype=torch.int32, device=device), *i32[2:],
                seq_start=0, hash_value=0)

        return {"name": f"powerlaw_sample/{name}",
                "source": "powerlaw_sample", "shape": (n, s),
                "plan": lambda sms: join_launch_plan(n, s, sms, skew),
                "run": run, "index_types": INDEX_TYPES,
                "static_smem": STATIC_SMEM_BYTES}

    return [case("b_preset", 1 << 15, 100_000),
            case("main_path", 1 << 23, 100_000),
            case("direct_limit", DIRECT - 1, 100_000),
            case("table_limit", DIRECT, 100_000),
            case("most_draws", MAX_DRAWS, 100_000),
            # the streaming step's halves at 2^23 records a chunk: the
            # marked rows from the row's start, the unmarked from 838,861
            join_case("join_marked", 838_861, 120_000, 0),
            join_case("join_unmarked", 7_549_747, 120_000, 1),
            join_case("join_direct_limit", DIRECT - 1, 120_000, 3)]
