"""Stable counting sort of packed shuffle words by destination.

Counterpart of ``repro/kernels/count_scatter/ops.py``, batched over the P
nodes: ``words`` and ``dest`` are int32 ``[B, n]``, one row per node.

- ``count_scatter`` is the entry point. It runs K1 (``count_tiles``:
  per-tile destination histogram), takes the exclusive prefix sums over
  destinations and over tiles in torch (``tile_bases``, as the JAX package
  does in jnp), and runs K2 (``scatter_tiles``: the stable scatter).
- ``count_tiles_plain`` / ``scatter_tiles_plain`` are the plain PyTorch
  versions of K1 and K2 (per-tile cumsums over a one-hot). Each wrapper
  runs its plain version on a CPU tensor and its kernel on a CUDA tensor,
  so the CPU runs the same composition and glue as the card.
- ``ref.count_scatter_ref`` (stable argsort) is the independent oracle.

Each CUDA wrapper counts its launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels._build import bind, library

TILE = 4096          # records per tile; equals kTile in csrc/count_scatter.cu
MAX_DESTS = 1025     # P + 1 destination counters per warp fit in shared
                     # memory (K2 opts in to 72 KB at 1025)


def _check_rows(name: str, *tensors: torch.Tensor) -> None:
    first = tensors[0]
    for t in tensors:
        if t.dtype != torch.int32:
            raise ValueError(f"{name}: expected int32 tensors, got {t.dtype}")
        if t.dim() != 2:
            raise ValueError(f"{name}: expected [rows, n] tensors, got "
                             f"shape {tuple(t.shape)}")
        if t.device != first.device:
            raise ValueError(f"{name}: tensors on {t.device} and "
                             f"{first.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    if first.shape[1] >= 2**31:
        raise ValueError(f"{name}: rows of {first.shape[1]} records exceed "
                         f"int32 offsets")


def _check_dests(name: str, num_dests: int, device: torch.device) -> None:
    if num_dests < 1:
        raise ValueError(f"{name}: num_dests must be >= 1, got {num_dests}")
    if device.type == "cuda" and num_dests > MAX_DESTS:
        raise ValueError(f"{name}: {num_dests} destinations exceed the "
                         f"kernel's {MAX_DESTS} shared-memory counters")


# argument kinds of each C entry point, as declared in csrc/count_scatter.cu
SIGNATURES = {"count_tiles": "ppqiiip", "scatter_tiles": "ppppqiiip",
              "count_scatter_tile": ""}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = bind(library("count_scatter"), SIGNATURES)
    if lib.count_scatter_tile() != TILE:
        raise RuntimeError("csrc/count_scatter.cu was built with another "
                           "record tile than ops.TILE")
    return lib


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def num_tiles(n: int) -> int:
    return -(-n // TILE)


def count_tiles_plain(dest: torch.Tensor, num_dests: int) -> torch.Tensor:
    """Plain K1: int32 ``[B, T, num_dests]`` destination counts per tile.
    Destinations outside ``[0, num_dests)`` count nowhere."""
    b, n = dest.shape
    t = num_tiles(n)
    ok = (dest >= 0) & (dest < num_dests)
    tile = torch.arange(n, device=dest.device) // TILE
    row = torch.arange(b, device=dest.device).unsqueeze(1)
    key = ((row * t + tile) * num_dests + dest).masked_fill(~ok, 0)
    out = torch.zeros(b * t * num_dests, dtype=torch.int32,
                      device=dest.device)
    out.index_add_(0, key.reshape(-1), ok.to(torch.int32).reshape(-1))
    return out.reshape(b, t, num_dests)


def count_tiles(dest: torch.Tensor, num_dests: int) -> torch.Tensor:
    """K1: per-tile destination histogram, int32 ``[B, T, num_dests]``."""
    _check_rows("count_tiles", dest)
    _check_dests("count_tiles", num_dests, dest.device)
    if dest.device.type != "cuda":
        return count_tiles_plain(dest, num_dests)
    b, n = dest.shape
    t = num_tiles(n)
    counts = torch.empty(b, t, num_dests, dtype=torch.int32,
                         device=dest.device)
    if counts.numel() == 0:
        return counts
    count_tiles.launches += 1
    _raise_on(_lib().count_tiles(dest.data_ptr(), counts.data_ptr(), n, b,
                                 num_dests, t, _stream(dest)),
              "count_tiles")
    return counts


count_tiles.launches = 0


def tile_bases(counts_t: torch.Tensor):
    """Glue between K1 and K2: ``(base [B, T, D], starts [B, D])``.

    ``starts[b, d]`` is the exclusive prefix sum over destinations of the
    row's counts; ``base[b, t, d]`` adds the exclusive prefix sum over the
    tiles before ``t``: the output offset of tile t's first record for d.
    """
    # the scan over tiles runs along the innermost axis: PyTorch scans a
    # middle axis with one thread per column, serially
    by_dest = counts_t.transpose(1, 2).contiguous()          # [B, D, T]
    counts = by_dest.sum(dim=-1, dtype=torch.int32)
    starts = torch.cumsum(counts, dim=-1, dtype=torch.int32) - counts
    tile_excl = torch.cumsum(by_dest, dim=-1, dtype=torch.int32) - by_dest
    base = (starts.unsqueeze(-1) + tile_excl).transpose(1, 2).contiguous()
    return base, starts


def scatter_tiles_plain(words: torch.Tensor, dest: torch.Tensor,
                        base: torch.Tensor) -> torch.Tensor:
    """Plain K2: ``out[b, base[b, t, d] + rank] = words[b, i]`` with rank
    the count of earlier records of tile t bound for d."""
    b, n = dest.shape
    num_dests = base.shape[2]
    t = num_tiles(n)
    pad = t * TILE - n
    d_t = torch.nn.functional.pad(dest, (0, pad), value=-1).reshape(b, t,
                                                                    TILE)
    ok = (d_t >= 0) & (d_t < num_dests)
    d_c = d_t.clamp(0, num_dests - 1).to(torch.int64)
    onehot = (d_c.unsqueeze(-1) == torch.arange(num_dests,
                                                device=dest.device)) \
        & ok.unsqueeze(-1)
    occ = torch.cumsum(onehot, dim=2, dtype=torch.int32)
    rank = occ.gather(3, d_c.unsqueeze(-1)).squeeze(-1) - 1
    pos = base.gather(2, d_c) + rank
    pos = pos.reshape(b, -1)[:, :n]
    ok = ok.reshape(b, -1)[:, :n]
    out = torch.zeros_like(words)
    row = torch.arange(b, device=dest.device).unsqueeze(1).expand(b, n)
    out[row[ok], pos[ok].to(torch.int64)] = words[ok]
    return out


def scatter_tiles(words: torch.Tensor, dest: torch.Tensor,
                  base: torch.Tensor) -> torch.Tensor:
    """K2: stable scatter of ``words`` to destination-contiguous order."""
    _check_rows("scatter_tiles", words, dest)
    if words.shape != dest.shape:
        raise ValueError(f"scatter_tiles: words {tuple(words.shape)} and "
                         f"dest {tuple(dest.shape)} differ")
    b, n = dest.shape
    t = num_tiles(n)
    if (base.dtype != torch.int32 or base.shape[:2] != (b, t)
            or base.device != dest.device or not base.is_contiguous()):
        raise ValueError(f"scatter_tiles: base must be contiguous int32 "
                         f"[{b}, {t}, D] on {dest.device}")
    num_dests = base.shape[2]
    _check_dests("scatter_tiles", num_dests, dest.device)
    if dest.device.type != "cuda":
        return scatter_tiles_plain(words, dest, base)
    out = torch.empty_like(words)
    if out.numel() == 0:
        return out
    scatter_tiles.launches += 1
    _raise_on(_lib().scatter_tiles(words.data_ptr(), dest.data_ptr(),
                                   base.data_ptr(), out.data_ptr(), n, b,
                                   num_dests, t, _stream(dest)),
              "scatter_tiles")
    return out


scatter_tiles.launches = 0


def count_scatter(words: torch.Tensor, dest: torch.Tensor,
                  num_partitions: int):
    """Stable counting sort of each row of ``words`` by ``dest``.

    ``dest`` must be int32 in ``[0, num_partitions]`` (``num_partitions``
    is the pseudo-destination of invalid rows). Returns ``(words_sorted,
    starts)``: each row permuted into destination-contiguous stable order
    (equal to a stable argsort and gather) and int32 ``[B, P+1]``
    exclusive segment starts.
    """
    _check_rows("count_scatter", words, dest)
    if words.shape != dest.shape:
        raise ValueError(f"count_scatter: words {tuple(words.shape)} and "
                         f"dest {tuple(dest.shape)} differ")
    counts_t = count_tiles(dest, num_partitions + 1)
    base, starts = tile_bases(counts_t)
    return scatter_tiles(words, dest, base), starts
