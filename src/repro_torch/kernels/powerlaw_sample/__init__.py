from repro_torch.kernels.powerlaw_sample.ops import (
    powerlaw_sample,
    powerlaw_sample_join,
    powerlaw_sample_join_plain,
    powerlaw_sample_plain,
)
from repro_torch.kernels.powerlaw_sample.ref import powerlaw_sample_ref

__all__ = ["powerlaw_sample", "powerlaw_sample_join",
           "powerlaw_sample_join_plain", "powerlaw_sample_plain",
           "powerlaw_sample_ref"]
