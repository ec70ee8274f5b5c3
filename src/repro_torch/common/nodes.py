"""The P nodes of the JAX mesh as a leading ``[P]`` axis on one device.

The JAX package runs one program per mesh device and joins them with
``jax.lax`` collectives. The port holds every node's data in one tensor
whose axis 0 is the node, so each collective becomes a tensor op:

- ``all_to_all`` of ``[P_src, P_dst, C]`` buckets is a transpose;
- ``psum`` is a sum over axis 0, in int32 (it wraps as the int32 psum
  does);
- ``psum_scatter`` (tiled) is that sum cut into P contiguous blocks, and
  ``all_gather`` of contiguous blocks a reshape;
- ``all_gather`` of the strided owned blocks plus the unstride of
  ``runner.py:174-176`` is a permute and a reshape.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for the CPU. Never falls back to the CPU on its own."""
    if device is None:
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the card by "
            "default — pass device='cpu' to run its plain PyTorch path")
    return device


def all_to_all(buckets: torch.Tensor) -> torch.Tensor:
    """``[P_src, P_dst, ...]`` -> ``[P_dst, P_src, ...]``: node d receives
    bucket d of every sender, in sender order."""
    return buckets.transpose(0, 1).contiguous()


def psum(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Sum of int32 values over the node axis ``dim``, wrapping modulo 2^32
    as the int32 JAX psum does."""
    s = x.sum(dim=dim, dtype=torch.int64)
    return (torch.remainder(s + 2**31, 2**32) - 2**31).to(torch.int32)


def psum_scatter(x: torch.Tensor) -> torch.Tensor:
    """Tiled reduce-scatter over axis 1: ``[P, S, ...]`` -> ``[P, S/P,
    ...]``, node d keeping the contiguous block ``[d*S/P, (d+1)*S/P)`` of
    the int32-wrapping sum over the nodes."""
    p, s = x.shape[:2]
    if s % p:
        raise ValueError(f"psum_scatter: {s} rows do not split over {p} "
                         f"nodes")
    return psum(x).reshape(p, s // p, *x.shape[2:])


def all_gather(blocks: torch.Tensor) -> torch.Tensor:
    """``[P, B, ...]`` contiguous blocks (node d holding rows ``[d*B,
    (d+1)*B)``) -> the full ``[P*B, ...]`` tensor."""
    return blocks.reshape(-1, *blocks.shape[2:])


def all_gather_unstride(owned: torch.Tensor) -> torch.Tensor:
    """``[P, S/P, W, 2]`` strided owned blocks (local row i of node d is
    global site ``i * P + d``) -> the full ``[S, W, 2]`` histogram."""
    p, s_local = owned.shape[:2]
    return owned.transpose(0, 1).reshape(p * s_local, *owned.shape[2:])
