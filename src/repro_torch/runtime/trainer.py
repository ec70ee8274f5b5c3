"""Fault-tolerant training runtime.

Counterpart of ``repro/runtime/trainer.py``, with its control flow. The
failure modes of a large fleet are designed in, and testable on the CPU by
injection:

- **Checkpoint/restart**: periodic checkpoints with atomic commit markers
  (``checkpoint/store.py``, JAX's layout); ``Trainer.run`` resumes from the
  latest committed step after a crash. Deterministic data (batch = f(seed,
  step, shard)) makes the resume exact.
- **Step retry**: a failed step (an exception from the step or from
  ``fault_hook``) is retried from the last good in-memory state; after
  ``max_retries`` the trainer restores from disk.
- **Bad-node attribution, the paper's technique**: every step appends a
  (host, step, time-bucket, failed/straggled) record; MalStone B and the
  CUSUM of ``core/nodedoctor.py`` attribute which host is *marking* its
  steps, and the trainer blocklists it and reassigns its steps. On the
  card, each doctor run finalizes MalStone B with K7 once.
- **Elastic rescale**: checkpoints restore across shard counts, and the
  data pipeline reassigns shards deterministically.

A step's duration is ``time.monotonic()`` around the fault hook, the batch,
the step and ``float(loss)``, which waits for the device: the straggler
test sees the device work.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.common.nodes import resolve_device
from repro_torch.common.types import SECONDS_PER_WEEK
from repro_torch.core.nodedoctor import diagnose, host_telemetry_log


@dataclasses.dataclass
class TrainConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: str = "/tmp/repro_ckpt"
    keep_ckpts: int = 3
    max_retries: int = 2
    max_restarts: int = 25            # hard stop on restore loops
    # straggler detection
    straggler_factor: float = 2.5     # step_time > factor * median -> mark
    doctor_every: int = 10
    doctor_buckets: int = 16
    telemetry_hosts: int = 8          # simulated host count


class Telemetry:
    """Site-entity-mark log of training steps (paper Table 1 instance),
    kept on the host; ``as_log`` builds its columns on ``device`` (the
    card unless ``device="cpu"``)."""

    def __init__(self, num_hosts: int, device=None):
        self.num_hosts = num_hosts
        self.device = resolve_device(device)
        self.host, self.step, self.bucket, self.mark = [], [], [], []
        self.durations: list[float] = []

    def record(self, host: int, step: int, bucket: int, failed: bool,
               duration: float):
        self.host.append(host)
        self.step.append(step)
        self.bucket.append(bucket)
        self.mark.append(int(failed))
        self.durations.append(duration)

    def straggled(self, duration: float, factor: float) -> bool:
        if len(self.durations) < 8:
            return False
        med = float(np.median(self.durations[-64:]))
        return duration > factor * med

    def as_log(self):
        def col(values):
            return torch.tensor(values, dtype=torch.int32,
                                device=self.device)

        return host_telemetry_log(col(self.host), col(self.step),
                                  col(self.bucket) * SECONDS_PER_WEEK,
                                  col(self.mark))


class Trainer:
    def __init__(self, cfg: TrainConfig, train_step: Callable,
                 init_state: Any, batch_fn: Callable[[int], dict],
                 host_of_step: Optional[Callable[[int], int]] = None,
                 fault_hook: Optional[Callable[[int, int], None]] = None,
                 device=None):
        """``train_step(state, batch) -> (state, metrics)``;
        ``batch_fn(step) -> batch`` (deterministic); ``host_of_step`` maps
        a step to the (simulated) host serving it; ``fault_hook(step,
        host)`` raises to inject failures. It receives the host actually
        serving the step, so blocklist-driven reassignment heals host-tied
        faults. ``device`` (the card unless ``device="cpu"``) is where the
        doctor runs."""
        self.cfg = cfg
        self.train_step = train_step
        self.state = init_state
        self.batch_fn = batch_fn
        self.host_of_step = host_of_step or (
            lambda s: s % cfg.telemetry_hosts)
        self.fault_hook = fault_hook
        self.device = resolve_device(device)
        self.ckpt = CheckpointManager(cfg.ckpt_dir, keep=cfg.keep_ckpts)
        self.telemetry = Telemetry(cfg.telemetry_hosts, self.device)
        self.blocklist: set[int] = set()
        self.history: list[dict] = []
        self.restarts = 0
        self.retries = 0

    # ------------------------------------------------------------------
    def resume_if_possible(self) -> int:
        step, restored = self.ckpt.restore_latest(self.state)
        if step is None:
            return 0
        self.state = restored
        return step + 1

    def run(self, start_step: Optional[int] = None) -> dict:
        step = self.resume_if_possible() if start_step is None else start_step
        cfg = self.cfg
        while step < cfg.total_steps:
            ok = self._one_step(step)
            if not ok:
                # exhausted retries: attribute blame BEFORE restoring so a
                # host-tied fault gets blocklisted and the replay reassigns
                self._run_doctor()
                if self.restarts >= self.cfg.max_restarts:
                    raise RuntimeError(
                        f"step {step}: exceeded max_restarts="
                        f"{self.cfg.max_restarts}: unrecoverable fault")
                restored_step, restored = self.ckpt.restore_latest(self.state)
                if restored is not None:
                    self.state = restored
                    step = restored_step + 1
                    self.restarts += 1
                    continue
                raise RuntimeError(f"step {step}: no checkpoint to restore")
            if (step + 1) % cfg.ckpt_every == 0:
                self.ckpt.save(step, self.state)
            if (step + 1) % cfg.doctor_every == 0:
                self._run_doctor()
            step += 1
        return {
            "final_step": step,
            "restarts": self.restarts,
            "retries": self.retries,
            "blocklist": sorted(self.blocklist),
            "history": self.history,
        }

    # ------------------------------------------------------------------
    def _one_step(self, step: int) -> bool:
        cfg = self.cfg
        host = self.host_of_step(step)
        if host in self.blocklist:
            host = self._reassign_host(host, step)
        bucket = min(step * cfg.doctor_buckets // max(cfg.total_steps, 1),
                     cfg.doctor_buckets - 1)
        for attempt in range(cfg.max_retries + 1):
            t0 = time.monotonic()
            try:
                if self.fault_hook is not None:
                    self.fault_hook(step, host)
                batch = self.batch_fn(step)
                new_state, metrics = self.train_step(self.state, batch)
                loss = float(metrics["loss"])
                if not math.isfinite(loss):
                    raise FloatingPointError(f"non-finite loss at {step}")
                dt = time.monotonic() - t0
                straggled = self.telemetry.straggled(
                    dt, cfg.straggler_factor)
                self.telemetry.record(host, step, bucket,
                                      failed=straggled, duration=dt)
                self.state = new_state
                self.history.append({"step": step, "loss": loss,
                                     "host": host, "dur": dt})
                return True
            except Exception:
                dt = time.monotonic() - t0
                self.telemetry.record(host, step, bucket, failed=True,
                                      duration=dt)
                self.retries += 1
                if attempt == cfg.max_retries:
                    return False
        return False

    def _reassign_host(self, bad: int, step: int) -> int:
        """Deterministic reassignment away from blocklisted hosts."""
        for k in range(1, self.cfg.telemetry_hosts + 1):
            cand = (bad + k) % self.cfg.telemetry_hosts
            if cand not in self.blocklist:
                return cand
        return bad

    def _run_doctor(self):
        if not self.telemetry.host:
            return
        rep = diagnose(self.telemetry.as_log(),
                       num_hosts=self.cfg.telemetry_hosts,
                       num_buckets=self.cfg.doctor_buckets)
        for h in torch.nonzero(rep.alarm).flatten().tolist():
            self.blocklist.add(int(h))
