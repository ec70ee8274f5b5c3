from repro_torch.kernels.count_scatter.ops import count_scatter
from repro_torch.kernels.count_scatter.ref import count_scatter_ref

__all__ = ["count_scatter", "count_scatter_ref"]
