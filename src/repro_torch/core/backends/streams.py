"""Hadoop-Streams-analogue backend: local combine + one all-reduce.

Counterpart of ``repro/core/backends/streams.py``. The statistic is a
commutative monoid fold, so each node combines its records into a dense
``[S, W, 2]`` histogram and only that summary crosses the network: one
local histogram per node of a ``[P, n]`` log, then one ``psum``.
"""

from __future__ import annotations

import torch

from repro_torch.common import nodes
from repro_torch.common.types import EventLog, WEEKS_PER_YEAR
from repro_torch.core.spm import site_week_histogram


def streams_histogram(log: EventLog, num_sites: int,
                      num_weeks: int = WEEKS_PER_YEAR,
                      histogram_fn=site_week_histogram) -> torch.Tensor:
    """The full ``[num_sites, num_weeks, 2]`` histogram (one copy; the JAX
    package replicates it on every device).

    ``histogram_fn(log, num_sites, num_weeks)`` is the local combine over
    the ``[P, n]`` log (K4 with ``histogram_impl="kernel"``).
    """
    return nodes.psum(histogram_fn(log, num_sites, num_weeks))
