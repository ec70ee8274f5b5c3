"""The record shuffle's round of shipped words, K9, on one card.

The word exchange (``core/backends/mapreduce.py:exchange_and_reduce``)
ships, each round r, window ``[r*C, (r+1)*C)`` of every destination segment
of every node's words, ordered by destination, in ``C``-slot buckets padded
with the zero word; the receivers reduce what they get (K3). ``ship_buckets
(words_sorted, starts, r, C)`` writes the round's buckets as the receivers
hold them, in one pass:

    shipped[d, s * C + c] = words_sorted[s, starts[s, d] + r*C + c]
                            if that index is below starts[s, d + 1], else 0

for receiver d, sender s and lane c < C, over int32 ``[P, n]`` words and
int32 ``[P, P + 1]`` segment starts, into int32 ``[P, P * C]``. On a CUDA
tensor the wrapper launches K9 (``csrc/ship_buckets.cu``, which replaces
no TPU kernel: the JAX package fills its buckets with XLA's gather and
ships them with ``all_to_all``); on a CPU tensor it runs
``ship_buckets_plain``, the torch path it replaces (the slot index, its
liveness mask, its int64 copy, the gather, the ``where``, then
``nodes.all_to_all``).

In a gang of processes a process holds the rows of its own senders only.
There K9 writes the senders' ``[P_local, P, C]`` buckets (row ``s * P +
d``), and ``nodes.all_to_all`` ships them to their receivers over gloo.

Launches are counted in ``ship_buckets.launches``, and the rounds they
serve in the trace counter ``shuffle.rounds_in_kernel``. The launch
counter stays out of ``repro_torch.kernels.KERNEL_WRAPPERS`` and
``launch_counts()``, whose names the benchmark's traced runs look up in a
table of kernel symbols that has no entry for K9. ``launch_plan`` mirrors
the C entry point's launch for the static analysis
(``repro_torch.kernels._launch``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.common import nodes, trace
from repro_torch.kernels._build import bind, kernel_attributes, library
from repro_torch.kernels._launch import Launch, cdiv, dim3

_INT32_MAX = 2**31 - 1

# K9's constants (csrc/ship_buckets.cu)
THREADS = 256
BLOCKS_PER_SM = 4
UNROLL = 4
TILE = THREADS * UNROLL

# the source's kernels, in the order of its kernel_attributes entry point
KERNELS = ("ship_buckets_kernel",)
# static shared memory of each kernel (none); chip_smoke.py's analysis
# holds this table against the card's
STATIC_SMEM_BYTES = {"ship_buckets_kernel": 0}
# the index type K9 forms its offsets into each array in
# (csrc/ship_buckets.cu:ship_buckets_kernel): the tiles in int64, a vector
# or int within a row in uint32, the rows' bases in int64
INDEX_TYPES = {"ship_buckets_kernel": {"tiles": "int64", "vectors": "uint32",
                                       "out": "int64", "words": "int64",
                                       "starts": "int64"}}

# argument kinds of K9's C entry point, as declared in its source
SIGNATURES = {"ship_buckets": "pppiiiiqip", "kernel_attributes": "ip"}


@functools.cache
def _lib() -> ctypes.CDLL:
    return bind(library("ship_buckets"), SIGNATURES)


def attributes() -> dict:
    """What the card reports for K9 (``_build.kernel_attributes``)."""
    return kernel_attributes(_lib(), KERNELS)


def vector_ints(words_ptr: int, out_ptr: int, n: int, capacity: int) -> int:
    """The ints a thread of K9 moves at a time (the entry point's choice):
    4 where a row of words and a bucket split into 16-byte vectors and both
    pointers are 16-byte aligned, else 1."""
    aligned = (words_ptr | out_ptr) % 16 == 0
    return 4 if aligned and n % 4 == 0 and capacity % 4 == 0 else 1


def _check_shape(parts: int, n: int, capacity: int) -> None:
    if parts < 1 or n < 0 or capacity < 1:
        raise ValueError(f"ship_buckets: P={parts}, n={n}, C={capacity}; "
                         f"P and C must be at least 1")
    if n > _INT32_MAX or capacity > _INT32_MAX:
        raise ValueError(f"ship_buckets: n={n} and C={capacity} must each "
                         f"be at most 2^31 - 1")


def launch_plan(parts: int, n: int, capacity: int, sm_count: int,
                vec: int = 4, senders: Optional[int] = None) -> list:
    """The launch of ``ship_buckets`` (K9) of ``[senders, n]`` words
    (default: all ``parts`` nodes) into ``senders * parts`` buckets of
    ``C`` with ``vec`` ints a thread (csrc/ship_buckets.cu:ship_buckets):
    a persistent grid of at most ``BLOCKS_PER_SM`` blocks an SM over the
    rows' tiles of ``TILE`` items, grid-stride. The layout does not change
    the launch."""
    senders = parts if senders is None else senders
    _check_shape(parts, n, capacity)
    rows = senders * parts
    row_tiles = cdiv(capacity // vec, TILE)
    tiles = rows * row_tiles
    grid = min(tiles, sm_count * BLOCKS_PER_SM)
    return [Launch(
        "ship_buckets_kernel", dim3(grid), dim3(THREADS),
        offsets={"tiles": tiles - 1 + grid,        # the loop's last step
                 "vectors": row_tiles * TILE - 1,
                 "out": rows * capacity - 1, "words": senders * n - 1,
                 "starts": senders * (parts + 1) - 1})]


def ship_buckets_plain(words_sorted: torch.Tensor, starts: torch.Tensor,
                       round_index: int, capacity: int,
                       group: Optional[nodes.NodeGroup] = None
                       ) -> torch.Tensor:
    """Plain version of K9, the torch path: every slot's index into its
    sender's words, the slots past a segment's end masked to the zero word,
    the gather, then ``nodes.all_to_all``. ``words_sorted`` and ``starts``
    hold the rows of ``group``'s nodes (default: every node, one process);
    a gang's ``all_to_all`` runs over gloo. Returns ``[P_local, P * C]``
    words per receiver. On CPU tensors only: the card takes K9."""
    rows, n = words_sorted.shape
    p = nodes.group_of_rows(group, rows).nodes
    lane = torch.arange(capacity, dtype=torch.int32,
                        device=words_sorted.device)
    idx = (starts[:, :-1] + round_index * capacity).unsqueeze(-1) + lane
    live = idx < starts[:, 1:].unsqueeze(-1)
    taken = words_sorted.gather(
        1, idx.clamp_(max=max(n - 1, 0)).reshape(rows, -1).to(torch.int64))
    buf = torch.where(live, taken.reshape(live.shape),
                      torch.zeros((), dtype=torch.int32,
                                  device=words_sorted.device))
    return nodes.all_to_all(buf, group).reshape(rows, p * capacity)


def ship_buckets(words_sorted: torch.Tensor, starts: torch.Tensor,
                 round_index: int, capacity: int,
                 group: Optional[nodes.NodeGroup] = None) -> torch.Tensor:
    """Round ``round_index``'s ``[P_local, P * C]`` shipped words of every
    receiver ``group`` holds (default: every node, one process), from its
    senders' int32 ``[P_local, n]`` words ordered by destination and their
    int32 ``[P_local, P + 1]`` segment starts; both contiguous, on one
    device; ``n`` and ``C`` at most 2^31 - 1. One K9 launch on the card,
    in the senders' layout where ``group`` is a gang; the plain version on
    the CPU."""
    for name, t in (("words_sorted", words_sorted), ("starts", starts)):
        if t.dtype != torch.int32 or t.dim() != 2:
            raise ValueError(f"ship_buckets: {name} must be 2-D int32, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"ship_buckets: {name} must be contiguous")
    rows, n = words_sorted.shape
    group = nodes.group_of_rows(group, rows)
    p = group.nodes
    if starts.shape != (rows, p + 1):
        raise ValueError(f"ship_buckets: words_sorted [{rows}, {n}] of "
                         f"{p} nodes needs starts of [{rows}, {p + 1}], got "
                         f"{tuple(starts.shape)} (P + 1 a row)")
    if starts.device != words_sorted.device:
        raise ValueError(f"ship_buckets: starts on {starts.device}, words "
                         f"on {words_sorted.device}")
    if round_index < 0:
        raise ValueError(f"ship_buckets: round {round_index} is negative")
    _check_shape(p, n, capacity)
    if words_sorted.device.type != "cuda":
        return ship_buckets_plain(words_sorted, starts, round_index, capacity,
                                  group)
    by_sender = group.distributed
    out = _launch(words_sorted, starts, round_index, capacity, p, by_sender)
    trace.count("shuffle.rounds_in_kernel")
    if by_sender:
        out = nodes.all_to_all(out.view(rows, p, capacity), group)
    return out.view(rows, p * capacity)


def _launch(words_sorted: torch.Tensor, starts: torch.Tensor,
            round_index: int, capacity: int, parts: int,
            by_sender: bool) -> torch.Tensor:
    """One K9 launch on the current stream: the receivers' ``[P, P * C]``
    words of one process's ``[P, n]`` senders, or, ``by_sender``, the
    senders' ``[P_local, P * C]`` buckets, row ``s * P + d``."""
    rows, n = words_sorted.shape
    out = torch.empty(rows, parts * capacity, dtype=torch.int32,
                      device=words_sorted.device)
    ship_buckets.launches += 1
    err = _lib().ship_buckets(
        words_sorted.data_ptr(), starts.data_ptr(), out.data_ptr(), rows,
        parts, n, capacity, round_index * capacity, int(by_sender),
        torch.cuda.current_stream(words_sorted.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ship_buckets: CUDA launch failed with error "
                           f"{err}")
    return out


ship_buckets.launches = 0


def analysis_cases() -> list:
    """The shapes the kernel passes check ``launch_plan`` at: the
    benchmark's mapreduce step (8 nodes of 2^23 words, C = 2^22, 16-byte
    vectors), a later round of a small bucket, a capacity that is no
    multiple of 4 (ints), the widest bucket the wrapper takes, and a gang
    rank's senders' layout (2 of 8 nodes at the step's widths)."""
    def case(name, p, n, capacity, round_index=0, senders=None):
        rows = p if senders is None else senders

        def run(device):
            words = torch.zeros(rows, n, dtype=torch.int32, device=device)
            starts = torch.arange(p + 1, dtype=torch.int32, device=device)
            starts = (starts * (n // p)).expand(rows, p + 1).contiguous()
            if senders is None:
                ship_buckets(words, starts, round_index, capacity)
            else:       # the launch alone: the gang's all_to_all is gloo's
                _launch(words, starts, round_index, capacity, p, True)

        # every allocation starts 16-byte aligned
        vec = vector_ints(0, 0, n, capacity)
        return {"name": f"ship_buckets/{name}", "source": "ship_buckets",
                "shape": (rows, n, capacity),
                "plan": lambda sms: launch_plan(p, n, capacity, sms, vec,
                                                senders),
                "run": run, "index_types": INDEX_TYPES,
                "static_smem": STATIC_SMEM_BYTES}

    return [case("main_path", 8, 2**23, 2**22),
            case("later_round", 4, 4096, 512, round_index=3),
            case("odd_capacity", 3, 1001, 333, round_index=1),
            case("widest_bucket", 1, 4, _INT32_MAX),
            case("gang_rank", 8, 2**23, 2**22, round_index=1, senders=2)]
