"""Sector/Sphere-analogue backend: local combine + reduce-scatter.

Counterpart of ``repro/core/backends/sphere.py``. Every node combines its
records locally, then a tiled ``psum_scatter`` leaves node d the reduced
histogram of one contiguous block of the site range; the output stays
partitioned and nothing is re-broadcast.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.common import nodes
from repro_torch.common.types import EventLog, WEEKS_PER_YEAR
from repro_torch.core.spm import site_week_histogram


def sphere_histogram(log: EventLog, num_sites: int,
                     num_weeks: int = WEEKS_PER_YEAR,
                     histogram_fn=site_week_histogram,
                     group: Optional[nodes.NodeGroup] = None
                     ) -> torch.Tensor:
    """Owned-block histograms ``[P_local, num_sites // P, num_weeks, 2]``
    of a ``[P_local, n]`` log: node d owns sites ``[d * S/P, (d+1) *
    S/P)``. ``num_sites`` must divide by P (the runner pads)."""
    return nodes.psum_scatter(histogram_fn(log, num_sites, num_weeks),
                              group)


def owned_site_range(node: int, parts: int,
                     num_sites: int) -> tuple[int, int]:
    """(start_site, block_size) of node ``node``'s owned block."""
    block = num_sites // parts
    return node * block, block
