"""Deterministic fault injection, retry policy, and failure telemetry.

Counterpart of ``repro/faults``:

- ``plan``      — a seeded ``FaultPlan`` + ``FaultInjector``: transient
                  per-(segment, host, attempt) failures, persistently bad
                  hosts, a delayed "straggler" host, and process kills at a
                  segment boundary or mid-checkpoint-write. Every decision
                  is a pure function of the plan seed, so any chaos
                  schedule replays exactly.
- ``retry``     — bounded retry-with-backoff: ``SegmentRetriesExhausted``
                  instead of silent drops when the budget runs out.
- ``telemetry`` — (segment, host, failed, duration-bucket) event buffer
                  feeding ``repro_torch.core.nodedoctor.diagnose``, so the
                  resumable runner reroutes shards away from alarmed hosts
                  instead of retrying them forever.

The faults are host-side only: they never touch the device's work, and a
real CUDA error is never retried.
"""

from repro_torch.faults.plan import (
    FaultError,
    FaultInjector,
    FaultPlan,
    NoHealthyHostsError,
    SimulatedKill,
    TransientWorkerError,
)
from repro_torch.faults.retry import RetryPolicy, SegmentRetriesExhausted
from repro_torch.faults.telemetry import TelemetryBuffer

__all__ = [
    "FaultError",
    "FaultInjector",
    "FaultPlan",
    "NoHealthyHostsError",
    "RetryPolicy",
    "SegmentRetriesExhausted",
    "SimulatedKill",
    "TelemetryBuffer",
    "TransientWorkerError",
]
