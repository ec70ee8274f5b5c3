"""Failure telemetry -> NodeDoctor attribution.

Counterpart of ``repro/faults/telemetry.py``. Every segment attempt
records one event per (shard -> host) execution unit: which host ran it,
which segment it belonged to, how long it took (bucketized), and whether
it failed. The buffer replays the events through
``repro_torch.core.nodedoctor``, the paper's SPM + CUSUM with site=host,
entity=segment, mark=failed, so the resumable runner can ask "which hosts
are marking the work they touch?" and reroute their shards. The diagnosis
runs on ``device`` (the card unless ``device="cpu"``), where its MalStone B
finalize is K7.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


class TelemetryBuffer:
    """Append-only (host, segment, duration-bucket, failed) event log."""

    def __init__(self, num_hosts: int, *, num_buckets: int = 8,
                 bucket_width_s: float = 0.05, device=None):
        if num_hosts < 1:
            raise ValueError(f"num_hosts must be >= 1, got {num_hosts}")
        self.num_hosts = num_hosts
        self.num_buckets = num_buckets
        self.bucket_width_s = bucket_width_s
        self.device = device
        self._events: List[Tuple[int, int, int, bool]] = []

    def bucket(self, duration_s: float) -> int:
        return min(int(duration_s / self.bucket_width_s),
                   self.num_buckets - 1)

    def record(self, host: int, segment: int, duration_s: float,
               failed: bool) -> None:
        if not 0 <= host < self.num_hosts:
            raise ValueError(
                f"host {host} out of range [0, {self.num_hosts})")
        self._events.append((host, segment, self.bucket(duration_s),
                             bool(failed)))

    def __len__(self) -> int:
        return len(self._events)

    @property
    def failures(self) -> int:
        return sum(1 for e in self._events if e[3])

    def diagnose(self, *, baseline: float = 0.05,
                 threshold_sigmas: float = 6.0):
        """Run the doctor over everything recorded so far.

        ``baseline`` defaults to a 5% tolerated flakiness floor rather
        than the doctor's data-derived median: early in a run the fleet
        has few events and a median of mostly-clean hosts clips to ~0,
        which would alarm any host after a single transient failure. A
        fixed floor keeps one-off transients quiet while a persistently
        failing host still accumulates CUSUM mass within a couple of
        attempts. Returns a ``nodedoctor.DoctorReport``.
        """
        # imported here: core imports this module through core/resume.py
        from repro_torch.core import nodedoctor

        hosts, segments, buckets, failed = zip(*self._events)
        return nodedoctor.diagnose_telemetry(
            list(hosts), list(segments), list(buckets), list(failed),
            num_hosts=self.num_hosts, num_buckets=self.num_buckets,
            baseline=baseline, threshold_sigmas=threshold_sigmas,
            device=self.device)

    def alarmed_hosts(self, **kw) -> list:
        """Host ids whose CUSUM alarm fired (empty without any failure:
        the doctor never alarms a clean fleet, so a fault-free run skips
        the diagnosis and its K7 launch)."""
        if not self._events or self.failures == 0:
            return []
        report = self.diagnose(**kw)
        return [int(h) for h in np.flatnonzero(report.alarm.cpu().numpy())]
