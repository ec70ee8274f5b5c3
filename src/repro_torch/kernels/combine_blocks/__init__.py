from repro_torch.kernels.combine_blocks.ops import (
    combine_blocks,
    combine_blocks_plain,
)

__all__ = ["combine_blocks", "combine_blocks_plain"]
