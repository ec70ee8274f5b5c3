from repro_torch.core.backends.mapreduce import (
    ShuffleExhaustedError,
    ShuffleStats,
    mapreduce_histogram,
    resolve_exchange_impl,
    shuffle_stats,
)

__all__ = ["ShuffleExhaustedError", "ShuffleStats", "mapreduce_histogram",
           "resolve_exchange_impl", "shuffle_stats"]
