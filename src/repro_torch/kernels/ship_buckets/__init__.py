from repro_torch.kernels.ship_buckets.ops import (
    ship_buckets,
    ship_buckets_plain,
)

__all__ = ["ship_buckets", "ship_buckets_plain"]
