"""The middleware dataflows of paper Section 6 over P nodes on one device.

Counterpart of ``repro/core/backends``: every backend computes the same
``[S, W, 2]`` site-week histogram and differs only in how bytes move
(``streams``: local combine + ``psum``; ``sphere``: local combine +
``psum_scatter``; ``mapreduce``: a record shuffle). ``BACKENDS`` names the
paper's three stacks; ``mapreduce_combiner`` is dispatched by the runner.
"""

from repro_torch.core.backends.mapreduce import (
    ShuffleExhaustedError,
    ShuffleStats,
    mapreduce_combiner_histogram,
    mapreduce_histogram,
    resolve_exchange_impl,
    shuffle_stats,
)
from repro_torch.core.backends.sphere import sphere_histogram
from repro_torch.core.backends.streams import streams_histogram

BACKENDS = ("streams", "sphere", "mapreduce")

__all__ = ["BACKENDS", "ShuffleExhaustedError", "ShuffleStats",
           "mapreduce_combiner_histogram", "mapreduce_histogram",
           "resolve_exchange_impl", "shuffle_stats", "sphere_histogram",
           "streams_histogram"]
