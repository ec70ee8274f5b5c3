"""The H100's peaks and the work of each kernel of the port, from shapes.

The byte and operation counts are the arithmetic that ``chip_smoke.py``
states for K1-K7 (inputs read once, outputs written once; K5's, K6's and
K7's operations counted too), owned here by the benchmark. A roofline
share is the least time the card could take, the larger of the bytes at
the memory rate and the operations at the 32-bit rate, over the time the
kernels took.
"""

from __future__ import annotations

# NVIDIA H100 SXM (HBM3) data sheet, at its 700 W limit: memory bandwidth,
# and the float32 rate outside the tensor cores (the sheet gives no
# separate INT32 rate).
HBM_BYTES_PER_S = 3.35e12
OPS32_PER_S = 67e12

TILE = 4096   # records a tile of K1 and K2 (csrc/count_scatter.cu kTile)


def k1_work(rows: int, n: int, num_partitions: int):
    """K1, ``count_tiles``: the destinations read, a counter a tile and
    destination written."""
    tiles = -(-n // TILE)
    return 4 * rows * n + 4 * rows * tiles * (num_partitions + 1), 0


def k2_work(rows: int, n: int, num_partitions: int):
    """K2, ``scatter_tiles``: words and destinations read, words written,
    the tile bases read."""
    tiles = -(-n // TILE)
    return 12 * rows * n + 4 * rows * tiles * (num_partitions + 1), 0


def k3_work(rows: int, words: int, s_local: int, num_weeks: int):
    """K3, ``segment_hist_packed_words`` over ``[rows, words]`` shipped
    words into ``[rows, s_local, W, 2]``."""
    return 4 * rows * words + 8 * rows * s_local * num_weeks, 0


def k4_work(rows: int, n: int, num_sites: int, num_weeks: int):
    """K4, ``segment_hist`` over ``[rows, n]`` columns (site, week and
    mark int32, valid one byte) into ``[rows, S, W, 2]``."""
    return 13 * rows * n + 8 * rows * num_sites * num_weeks, 0


def k5_work(num_sites: int, num_weeks: int, num_queries: int, runs: int):
    """K5, ``masked_window_ratio`` of N queries whose masks have ``runs``
    runs of set weeks in all: the histogram read, the masks read, three
    ``[N, S]`` answers written; the running sums of both channels, a
    subtract and an add a run and site, a divide an answer."""
    s, w, n = num_sites, num_weeks, num_queries
    return (8 * s * w + 2 * n * w + 12 * n * s,
            2 * s * w + 2 * runs * s + n * s)


def k6_work(n: int, num_sites: int):
    """K6, ``powerlaw_sample`` of n draws under an S-entry CDF: draws read,
    sites written, the CDF read; a search step a draw and CDF level."""
    return 8 * n + 4 * num_sites, n * num_sites.bit_length()


def k7_work(num_sites: int, num_weeks: int):
    """K7, ``windowed_ratio`` of ``[S, W, 2]``."""
    return 20 * num_sites * num_weeks, 3 * num_sites * num_weeks


def mask_runs(mask_rows) -> int:
    """Runs of set weeks over bool mask rows (sequences of 0/1)."""
    runs = 0
    for row in mask_rows:
        prev = False
        for bit in row:
            bit = bool(bit)
            runs += bit and not prev
            prev = bit
    return runs


def bound_seconds(nbytes: float, ops: float) -> tuple:
    """(least seconds, "bytes" or "operations": which bounds it)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / OPS32_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def share(nbytes: float, ops: float, seconds: float):
    """The roofline share in percent of work done in ``seconds`` of kernel
    time, with what bounds it; ``None`` where no kernel time was read."""
    if seconds <= 0 or nbytes + ops <= 0:
        return None
    least, by = bound_seconds(nbytes, ops)
    return {"value": 100.0 * least / seconds, "bound_by": by}


def padded_sites(config: dict) -> int:
    """Sites padded to a multiple of the node count (the carry's rows)."""
    p = config["nodes"]
    return -(-config["malgen"]["num_sites"] // p) * p


def kernel_seconds(run, fragments) -> float:
    """Summed device time, in the traced window, of the kernels whose
    names hold any of ``fragments``."""
    from malbench.trace import kernel_records

    return sum(kernel_records(run.trace["ops"], f)[1] for f in fragments)
