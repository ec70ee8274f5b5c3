"""The work of K8, the combiner's histogram-block exchange
(``repro_torch/kernels/csrc/combine_blocks.cu``), from shapes, beside
``roofline.py``'s K1-K7."""

from __future__ import annotations


def k8_work(rows: int, s_pad: int, num_weeks: int):
    """K8, ``combine_blocks`` of ``[rows, s_pad, W, 2]`` int32 local
    histograms into the owned ``[rows, s_pad / rows, W, 2]`` carry: every
    sender's histogram read once, the carry read and written once (its
    integer adds are not counted, as K3's and K4's are not)."""
    return 8 * s_pad * num_weeks * (rows + 2), 0
