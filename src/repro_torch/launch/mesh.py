"""The gang's nodes: which of the P nodes this process holds, and the data
every process must agree on.

Counterpart of ``make_global_mesh`` and ``replicate_to_mesh`` of
``repro/launch/mesh.py``. The JAX package's global mesh spans every
process's devices; here a :class:`~repro_torch.common.nodes.NodeGroup`
says which contiguous block of the P nodes this process holds, and the
collectives of ``repro_torch.common.nodes`` join the blocks.
``shard_log_to_mesh``'s counterpart is ``NodeGroup.rows``: the drivers
take the global log and keep the group's rows (``runner._node_log``). ``make_production_mesh``,
``batch_axes`` and ``make_host_mesh`` serve the language-model substrate's
pipeline parallelism and have no counterpart yet (ROADMAP.md Queue 1
item 9e).
"""

from __future__ import annotations

import hashlib

import torch
import torch.distributed as dist

from repro_torch.common.nodes import NodeGroup


def global_nodes(num_nodes: int) -> NodeGroup:
    """This process's :class:`NodeGroup` of ``num_nodes`` nodes: its block
    of the default ``torch.distributed`` group once the gang has joined
    (``coordinator.initialize``), every node in a single process. The
    nodes must divide evenly over the processes (``NodeGroup`` checks)."""
    if not (dist.is_available() and dist.is_initialized()):
        return NodeGroup(num_nodes)
    return NodeGroup(num_nodes, rank=dist.get_rank(),
                     world=dist.get_world_size())


def checksum(tensors) -> int:
    """A 64-bit digest of the tensors' dtypes, shapes and bytes."""
    h = hashlib.blake2b(digest_size=8)
    for t in tensors:
        t = t.detach().cpu().contiguous()
        h.update(f"{t.dtype}{tuple(t.shape)}".encode())
        h.update(t.view(torch.uint8).numpy().tobytes() if t.numel() else b"")
    return int.from_bytes(h.digest(), "little", signed=True)


def replicate(seed, group: NodeGroup):
    """The seed every process of the gang builds for itself from the same
    ``rng_seed`` (as the JAX package's processes do from the same root
    key), checked: the processes ``all_gather`` one 64-bit checksum of the
    seed's tensors and its integers, and any difference raises on every
    process. Returns ``seed`` unchanged."""
    if not group.distributed:
        return seed
    fields = [v for v in seed if isinstance(v, torch.Tensor)]
    ints = torch.tensor([v for v in seed if isinstance(v, int)],
                        dtype=torch.int64)
    mine = torch.tensor([checksum([*fields, ints])], dtype=torch.int64)
    every = [torch.empty_like(mine) for _ in range(group.world)]
    dist.all_gather(every, mine)
    sums = [int(t[0]) for t in every]
    if len(set(sums)) != 1:
        raise RuntimeError(
            f"the gang's processes built different seeds (checksums by "
            f"rank: {sums}); each must build it from the same rng_seed and "
            f"MalGenConfig")
    return seed

