from repro_torch.kernels.windowed_ratio.ops import (
    masked_window_ratio,
    masked_window_ratio_plain,
    windowed_ratio,
    windowed_ratio_plain,
)
from repro_torch.kernels.windowed_ratio.ref import (
    masked_window_ratio_ref,
    windowed_ratio_ref,
)

__all__ = ["masked_window_ratio", "masked_window_ratio_plain",
           "masked_window_ratio_ref", "windowed_ratio",
           "windowed_ratio_plain", "windowed_ratio_ref"]
