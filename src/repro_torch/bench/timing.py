"""The port's timing protocol (counterpart of ``repro/bench/timing.py``).

Each sample is one call between two host clock reads, and the device is
synchronised before each read, so a sample holds the call's device work
and not only its launch. Warm-up calls run first (at least one, so the
kernels' first-use build never lands in a sample) and go on until two
consecutive timings agree within ``steady_rtol`` or ``max_warmup`` ran.
The headline is the median; ``rel_dispersion`` is IQR / median.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Any, Callable, Optional, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class TimingResult:
    """One timed callable (the fields of the JAX package's)."""

    us_per_call: float        # median over the measured iterations
    us_min: float
    us_mean: float
    us_std: float             # population std (0.0 when iters == 1)
    rel_dispersion: float     # IQR / median (0.0 when iters < 4)
    samples_us: Tuple[float, ...]
    warmup_iters: int
    iters: int
    steady: bool              # consecutive warm-up timings agreed

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["samples_us"] = list(self.samples_us)
        return d


def _quartile_spread(samples: Sequence[float]) -> float:
    if len(samples) < 4:
        return 0.0
    q = statistics.quantiles(samples, n=4)
    med = statistics.median(samples)
    return (q[2] - q[0]) / med if med > 0 else 0.0


def timing_from_samples(samples_us: Sequence[float], *,
                        warmup_iters: int = 0,
                        steady: bool = False) -> TimingResult:
    """A ``TimingResult`` from samples (microseconds) taken elsewhere."""
    samples = [float(s) for s in samples_us]
    if not samples:
        raise ValueError("need at least one sample")
    return TimingResult(
        us_per_call=statistics.median(samples),
        us_min=min(samples),
        us_mean=statistics.fmean(samples),
        us_std=statistics.pstdev(samples) if len(samples) > 1 else 0.0,
        rel_dispersion=_quartile_spread(samples),
        samples_us=tuple(samples),
        warmup_iters=warmup_iters,
        iters=len(samples),
        steady=steady)


def synchronize() -> None:
    """Wait for the card's work (nothing to wait for without one)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _timed_call(fn: Callable, args: tuple) -> Tuple[float, Any]:
    synchronize()
    t0 = time.perf_counter()
    out = fn(*args)
    synchronize()
    return time.perf_counter() - t0, out


def time_callable(fn: Callable, *args, warmup: int = 2, iters: int = 5,
                  steady_rtol: float = 0.25, max_warmup: int = 8,
                  on_sample: Optional[Callable[[int, float], None]] = None
                  ) -> Tuple[TimingResult, Any]:
    """Time ``fn(*args)``; return (TimingResult, the last call's result).
    ``on_sample(i, us)`` runs after each measured call."""
    if iters < 1:
        raise ValueError(f"iters must be >= 1, got {iters}")
    floor = max(1, warmup)
    prev, out = _timed_call(fn, args)
    ran, steady = 1, False
    while ran < floor or (not steady and ran < max_warmup):
        dt, out = _timed_call(fn, args)
        ran += 1
        lo = min(prev, dt)
        steady = lo > 0 and abs(dt - prev) / lo <= steady_rtol
        prev = dt
        if ran >= floor and steady:
            break
    samples = []
    for i in range(iters):
        dt, out = _timed_call(fn, args)
        samples.append(dt * 1e6)
        if on_sample is not None:
            on_sample(i, dt * 1e6)
    return timing_from_samples(samples, warmup_iters=ran, steady=steady), out
