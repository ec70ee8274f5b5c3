"""The first designs of K2 (the stable scatter), K5 (the masked window
ratio), K6 (the power-law sampler) and K7 (the MalStone B finalizer), built
from ``tools/csrc/first_designs.cu``, as yardsticks that are timed beside
the port's kernels on the same inputs. The port never calls them.

    import first_designs as fd       # with tools/ on sys.path
    base = fd.tile_bases(fd.count_tiles(dest, num_dests))
    words_sorted = fd.scatter_tiles(words, dest, base)
    rho, num, den = fd.masked_window_ratio(hist, nmask, dmask)
    sites = fd.powerlaw_sample(u, cdf)
    rho, cum_total, cum_marked = fd.windowed_ratio(hist)

K1 and K2 of the first design use its tile of 1,024 records. Every
function needs CUDA tensors; the checks of ``repro_torch``'s wrappers are
not repeated.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import pathlib
import subprocess

import torch

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "first_designs.cu"
TILE = 1024   # the first K2 design's tile; equals k2_first::kTile


@functools.cache
def library() -> ctypes.CDLL:
    """Build the source with the port's nvcc flags (once per content)."""
    from repro_torch.kernels import _build

    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(_build.NVCC_FLAGS).encode())
    out = _build.BUILD_DIR / f"first_designs-{digest.hexdigest()[:16]}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(".tmp")
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(tmp),
                        str(SOURCE)], check=True, capture_output=True,
                       text=True)
        tmp.replace(out)
    # bound here, not with _build.bind: another checkout's repro_torch
    # (tools/kernel_turns.py --other) may not have it
    lib = ctypes.CDLL(str(out))
    kinds = {"p": ctypes.c_void_p, "q": ctypes.c_longlong, "i": ctypes.c_int}
    for name, sig in (("count_tiles_first", "ppqiiip"),
                      ("scatter_tiles_first", "ppppqiiip"),
                      ("masked_window_ratio_first", "ppppppiiip"),
                      ("powerlaw_sample_first", "pppqip"),
                      ("windowed_ratio_first", "ppppiip"),
                      ("count_scatter_tile_first", "")):
        fn = getattr(lib, name)
        fn.argtypes = [kinds[k] for k in sig]
        fn.restype = ctypes.c_int
    if lib.count_scatter_tile_first() != TILE:
        raise RuntimeError("first_designs.cu has another tile than TILE")
    return lib


def _run(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} (first design): CUDA error {err}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def count_tiles(dest: torch.Tensor, num_dests: int) -> torch.Tensor:
    b, n = dest.shape
    t = -(-n // TILE)
    counts = torch.empty(b, t, num_dests, dtype=torch.int32,
                         device=dest.device)
    _run(library().count_tiles_first(dest.data_ptr(), counts.data_ptr(), n,
                                     b, num_dests, t, _stream(dest)),
         "count_tiles")
    return counts


def tile_bases(counts_t: torch.Tensor) -> torch.Tensor:
    """The first design's bases: the port's glue over its own tiles."""
    from repro_torch.kernels.count_scatter.ops import tile_bases as glue

    return glue(counts_t)[0]


def scatter_tiles(words: torch.Tensor, dest: torch.Tensor,
                  base: torch.Tensor) -> torch.Tensor:
    b, n = dest.shape
    out = torch.empty_like(words)
    _run(library().scatter_tiles_first(
        words.data_ptr(), dest.data_ptr(), base.data_ptr(), out.data_ptr(),
        n, b, base.shape[2], base.shape[1], _stream(dest)), "scatter_tiles")
    return out


def masked_window_ratio(hist: torch.Tensor, num_masks: torch.Tensor,
                        den_masks: torch.Tensor):
    s, w, _ = hist.shape
    n = num_masks.shape[0]
    rho = torch.empty(n, s, dtype=torch.float32, device=hist.device)
    num = torch.empty(n, s, dtype=torch.int32, device=hist.device)
    den = torch.empty_like(num)
    _run(library().masked_window_ratio_first(
        hist.data_ptr(), num_masks.data_ptr(), den_masks.data_ptr(),
        rho.data_ptr(), num.data_ptr(), den.data_ptr(), s, w, n,
        _stream(hist)), "masked_window_ratio")
    return rho, num, den


def powerlaw_sample(u: torch.Tensor, cdf: torch.Tensor) -> torch.Tensor:
    out = torch.empty(u.shape[0], dtype=torch.int32, device=u.device)
    _run(library().powerlaw_sample_first(
        u.data_ptr(), cdf.data_ptr(), out.data_ptr(), u.shape[0],
        cdf.shape[0], _stream(u)), "powerlaw_sample")
    return out


def windowed_ratio(hist: torch.Tensor):
    s, w, _ = hist.shape
    rho = torch.empty(s, w, dtype=torch.float32, device=hist.device)
    cum_total = torch.empty(s, w, dtype=torch.int32, device=hist.device)
    cum_marked = torch.empty_like(cum_total)
    _run(library().windowed_ratio_first(
        hist.data_ptr(), rho.data_ptr(), cum_total.data_ptr(),
        cum_marked.data_ptr(), s, w, _stream(hist)), "windowed_ratio")
    return rho, cum_total, cum_marked
