"""Bounded retry-with-backoff for segment execution.

Counterpart of ``repro/faults/retry.py``, copied (the port imports nothing
of the JAX package).

Modeled on lithops' ``retries.py`` semantics: a fixed attempt budget with
exponential backoff, and an *explicit* ``SegmentRetriesExhausted`` when the
budget runs out — a resumable run may fail, but it must never silently
lose data (the invariant the chaos property tests in ``tests/test_faults``
sweep for).
"""

from __future__ import annotations

import dataclasses
import time


class SegmentRetriesExhausted(RuntimeError):
    """A segment failed on every attempt of its retry budget."""

    def __init__(self, msg: str, *, segment: int, attempts: int,
                 last_error: Exception):
        super().__init__(msg)
        self.segment = segment
        self.attempts = attempts
        self.last_error = last_error


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Attempt budget + exponential backoff schedule.

    ``max_attempts`` counts *total* tries (1 = no retries). ``sleep`` is
    injectable so tests and benchmarks run with zero wall-clock backoff.
    """

    max_attempts: int = 3
    backoff_s: float = 0.05
    backoff_factor: float = 2.0
    max_backoff_s: float = 2.0
    sleep = staticmethod(time.sleep)

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(
                f"max_attempts must be >= 1, got {self.max_attempts}")

    def backoff(self, attempt: int) -> float:
        """Backoff before retry number ``attempt`` (attempt 1 = first
        retry)."""
        if self.backoff_s <= 0.0:
            return 0.0
        return min(self.backoff_s * self.backoff_factor ** (attempt - 1),
                   self.max_backoff_s)

    def wait(self, attempt: int, sleep=None) -> float:
        delay = self.backoff(attempt)
        if delay > 0.0:
            (sleep or time.sleep)(delay)
        return delay
