"""Hand-written CUDA kernels of the port, by name, with their launch
counters (each wrapper adds one to ``<wrapper>.launches`` where it launches
its kernel, and nowhere else)."""

from repro_torch.kernels.count_scatter.ops import count_tiles, scatter_tiles
from repro_torch.kernels.segment_hist.ops import (
    segment_hist,
    segment_hist_packed_words,
)
from repro_torch.kernels.windowed_ratio.ops import masked_window_ratio

KERNEL_WRAPPERS = {
    "count_scatter.count": count_tiles,
    "count_scatter.scatter": scatter_tiles,
    "segment_hist.packed": segment_hist_packed_words,
    "segment_hist": segment_hist,
    "windowed_ratio.masked": masked_window_ratio,
}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNEL_WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0
