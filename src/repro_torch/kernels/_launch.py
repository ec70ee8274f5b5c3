"""Launch plans: what a kernel wrapper's C entry point launches, in Python.

Each kernel package's ``ops.py`` has a ``launch_plan(...)`` that returns,
for the shapes its wrapper takes, one :class:`Launch` for each
``<<<...>>>`` the C entry point makes, with the host arithmetic of that
entry point mirrored line by line, and an ``analysis_cases()`` that names
the shapes ``repro_torch.analysis`` checks them at. Nothing here touches a
card: the plans are pure Python, so the kernel passes run on the CPU, and
on the card ``chip_smoke.py`` holds them against the profiler's records of
the real launches.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

H100_SMS = 132       # SMs of an H100 SXM: the card the static passes plan for


@dataclasses.dataclass(frozen=True)
class Launch:
    """One kernel launch.

    - ``kernel``: the ``__global__`` function's name in its source;
    - ``grid`` and ``block``: ``(x, y, z)``;
    - ``dynamic_smem``: the launch's dynamic shared memory in bytes;
    - ``opt_in``: the bytes the entry point sets with
      ``cudaFuncAttributeMaxDynamicSharedMemorySize`` before the launch,
      or ``None`` where it sets none;
    - ``offsets``: array -> the largest element offset the kernel forms
      into it (a loop bound or a vector's end included), which the index
      type the source uses for that array must hold;
    - ``covers``: for a tile kernel, ``(items, per_block)`` along each grid
      axis from x: the grid must reach every record or site.
    """

    kernel: str
    grid: tuple
    block: tuple
    dynamic_smem: int = 0
    opt_in: Optional[int] = None
    offsets: dict = dataclasses.field(default_factory=dict)
    covers: tuple = ()


def dim3(*xs: int) -> tuple:
    """``dim3``'s ``(x, y, z)``, missing dimensions 1."""
    return tuple(xs) + (1,) * (3 - len(xs))


def cdiv(a: int, b: int) -> int:
    return -(-a // b)
