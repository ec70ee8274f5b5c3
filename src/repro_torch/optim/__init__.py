from repro_torch.optim.adamw import (
    AdamWConfig,
    OptState,
    adamw_init,
    adamw_update,
)
from repro_torch.optim.schedule import cosine_schedule, linear_warmup_cosine
from repro_torch.optim.compression import (
    compress_int8,
    decompress_int8,
    ef_compress_update,
)

__all__ = [
    "AdamWConfig",
    "OptState",
    "adamw_init",
    "adamw_update",
    "cosine_schedule",
    "linear_warmup_cosine",
    "compress_int8",
    "decompress_int8",
    "ef_compress_update",
]
