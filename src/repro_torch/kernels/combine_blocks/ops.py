"""The combiner's histogram-block exchange, K8, on one card.

MapReduce with a combiner (``core/backends/mapreduce.py:
mapreduce_combiner_histogram``) pre-reduces each node's records into a
local ``[S, W, 2]`` histogram (K4) and ships histogram blocks: node d owns
the strided sites ``i * P + d``, so it receives block d of every sender and
sums them. ``combine_blocks(local, carry)`` does that exchange and the sum
for every node of one process in one pass, in place:

    carry[d, i, w, c] += sum_src local[src, i * P + d, w, c]

over int32 ``[P, S, W, 2]`` local histograms into the int32 ``[P, S/P, W,
2]`` owned carry, the sum wrapping modulo 2^32 as ``common/nodes.py:psum``
wraps. On a CUDA tensor the wrapper launches K8 (``csrc/combine_blocks.cu``,
which replaces no TPU kernel: the JAX package leaves the exchange to XLA);
on a CPU tensor it runs ``combine_blocks_plain``, the torch path it
replaces (``nodes.all_to_all`` of the blocks, ``nodes.psum`` over the
senders, the add).

Launches are counted in ``combine_blocks.launches``. The counter stays out
of ``repro_torch.kernels.KERNEL_WRAPPERS`` and ``launch_counts()``, whose
names the benchmark's traced runs look up in a table of kernel symbols
that has no entry for K8. ``launch_plan`` mirrors the C entry point's
launch for the static analysis (``repro_torch.kernels._launch``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.common import nodes
from repro_torch.kernels._build import bind, kernel_attributes, library
from repro_torch.kernels._launch import Launch, cdiv, dim3

_INT32_MAX = 2**31 - 1

# K8's constants (csrc/combine_blocks.cu)
THREADS = 256
BLOCKS_PER_SM = 4

# the source's kernels, in the order of its kernel_attributes entry point
KERNELS = ("combine_blocks_kernel",)
# static shared memory of each kernel (none); chip_smoke.py's analysis
# holds this table against the card's
STATIC_SMEM_BYTES = {"combine_blocks_kernel": 0}
# the index type K8 forms its offsets into each array in
# (csrc/combine_blocks.cu:combine): vectors within one node's histogram
# and the carry in uint32, a sender's vector in int64
INDEX_TYPES = {"combine_blocks_kernel": {"vectors": "uint32",
                                         "carry": "uint32",
                                         "local": "int64"}}

# argument kinds of K8's C entry point, as declared in its source
SIGNATURES = {"combine_blocks": "ppiiip", "kernel_attributes": "ip"}


@functools.cache
def _lib() -> ctypes.CDLL:
    return bind(library("combine_blocks"), SIGNATURES)


def attributes() -> dict:
    """What the card reports for K8 (``_build.kernel_attributes``)."""
    return kernel_attributes(_lib(), KERNELS)


def vector_ints(local_ptr: int, carry_ptr: int, num_weeks: int) -> int:
    """The ints a thread of K8 takes at a time for these addresses and
    weeks (the entry point's choice): 4 where a site row of 2W ints splits
    into 16-byte vectors and both pointers are 16-byte aligned, else 2
    where they are 8-byte aligned, else 1."""
    both = local_ptr | carry_ptr
    if (2 * num_weeks) % 4 == 0 and both % 16 == 0:
        return 4
    return 2 if both % 8 == 0 else 1


def _check_shape(parts: int, s_local: int, num_weeks: int) -> None:
    if min(parts, s_local, num_weeks) < 1:
        raise ValueError(f"combine_blocks: P={parts}, S/P={s_local}, "
                         f"W={num_weeks}; each must be at least 1")
    if parts * s_local * 2 * num_weeks > _INT32_MAX:
        raise ValueError(f"combine_blocks: a node's histogram of "
                         f"{parts * s_local} sites x {num_weeks} weeks x 2 "
                         f"is over 2^31 - 1 ints")


def launch_plan(parts: int, s_local: int, num_weeks: int, sm_count: int,
                vec: int = 4) -> list:
    """The launch of ``combine_blocks`` (K8) over ``[P, P * S_local, W,
    2]`` local histograms with ``vec`` ints a thread
    (csrc/combine_blocks.cu:combine_blocks): a persistent grid of at most
    ``BLOCKS_PER_SM`` blocks an SM walking one node's histogram in vectors,
    grid-stride."""
    _check_shape(parts, s_local, num_weeks)
    n = parts * s_local * 2 * num_weeks // vec
    grid = min(cdiv(n, THREADS), sm_count * BLOCKS_PER_SM)
    return [Launch(
        "combine_blocks_kernel", dim3(grid), dim3(THREADS),
        offsets={"vectors": n - 1 + grid * THREADS,   # the loop's last step
                 "carry": n - 1, "local": parts * n - 1})]


def combine_blocks_plain(local: torch.Tensor, carry: torch.Tensor,
                         group: Optional[nodes.NodeGroup] = None
                         ) -> torch.Tensor:
    """Plain version of K8, the torch path: the blocks regrouped by owner
    (a view), ``nodes.all_to_all`` (a transposed copy), ``nodes.psum``
    over the senders (an int64 sum wrapped to int32), added into
    ``carry``, which it returns. ``local`` holds the rows of ``group``'s
    nodes (default: every node, one process); a gang's collectives run
    over gloo."""
    rows, s, w, _ = local.shape
    p = nodes.group_of_rows(group, rows).nodes
    # [P_local (src), P (dst), S/P, W, 2]: block (d, i) is site i * P + d
    blocks = local.reshape(rows, s // p, p, w, 2).transpose(1, 2)
    carry += nodes.psum(nodes.all_to_all(blocks, group), dim=1)
    return carry


def combine_blocks(local: torch.Tensor, carry: torch.Tensor) -> torch.Tensor:
    """Add every node's block of ``local`` int32 ``[P, S, W, 2]`` into its
    owned rows of ``carry`` int32 ``[P, S/P, W, 2]``, in place, wrapping
    modulo 2^32; returns ``carry``. Both contiguous, on one device, not
    overlapping; ``S`` a multiple of P and ``S * 2W`` at most 2^31 - 1."""
    for name, t in (("local", local), ("carry", carry)):
        if t.dtype != torch.int32 or t.dim() != 4 or t.shape[3] != 2:
            raise ValueError(f"combine_blocks: {name} must be int32 "
                             f"[P, S, W, 2], got {t.dtype} "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"combine_blocks: {name} must be contiguous")
    p, s, w, _ = local.shape
    if s % p or carry.shape != (p, s // p, w, 2):
        raise ValueError(f"combine_blocks: local {tuple(local.shape)} "
                         f"needs a carry of [P, S/P, W, 2] with S a "
                         f"multiple of P, got {tuple(carry.shape)}")
    _check_shape(p, s // p, w)
    if carry.device != local.device:
        raise ValueError(f"combine_blocks: carry on {carry.device}, local "
                         f"on {local.device}")
    a, b = local.data_ptr(), carry.data_ptr()
    if a < b + carry.numel() * 4 and b < a + local.numel() * 4:
        raise ValueError("combine_blocks: carry overlaps local")
    if local.device.type != "cuda":
        return combine_blocks_plain(local, carry)
    combine_blocks.launches += 1
    err = _lib().combine_blocks(
        a, b, p, s // p, w, torch.cuda.current_stream(local.device)
        .cuda_stream)
    if err != 0:
        raise RuntimeError(f"combine_blocks: CUDA launch failed with error "
                           f"{err}")
    return carry


combine_blocks.launches = 0


def analysis_cases() -> list:
    """The shapes the kernel passes check ``launch_plan`` at: the
    benchmark's B-10 combiner step (8 nodes, 120,000 sites, 52 weeks,
    16-byte vectors), an odd week count (8-byte vectors), both tensors one
    int past an 8-byte boundary (4-byte vectors), and the widest node
    histogram the wrapper takes."""
    def case(name, p, s_local, w, skew=0):
        def run(device):
            local = torch.zeros(p * p * s_local * w * 2 + skew,
                                dtype=torch.int32, device=device)[skew:]
            carry = torch.zeros(p * s_local * w * 2 + skew,
                                dtype=torch.int32, device=device)[skew:]
            combine_blocks(local.view(p, p * s_local, w, 2),
                           carry.view(p, s_local, w, 2))

        # an allocation starts 16-byte aligned; the views start skew ints on
        vec = vector_ints(4 * skew, 4 * skew, w)
        return {"name": f"combine_blocks/{name}", "source": "combine_blocks",
                "shape": (p, s_local, w),
                "plan": lambda sms: launch_plan(p, s_local, w, sms, vec),
                "run": run, "index_types": INDEX_TYPES,
                "static_smem": STATIC_SMEM_BYTES}

    return [case("main_path", 8, 15_000, 52),
            case("odd_weeks", 4, 1_001, 51),
            case("off_boundary", 3, 700, 52, skew=1),
            case("widest_node", 1, (_INT32_MAX // 104), 52)]
